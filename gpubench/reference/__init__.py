"""Plain float32 references of the benchmark's configurations.

Plain PyTorch with TF32 off, blocked so that it fits beside nothing but
itself; it imports nothing of the program under test.  ``model.Reference``
runs a dense GQA transformer (Phi-4-mini) or DeepSeek-V2's MLA and MoE
layers from a configuration file's keys and a function that hands it
each weight group in float32.
"""
