"""Tiny configurations of the benchmark's two architectures, for CPU tests:
the same keys as the configuration files, at widths a test can hold."""
import copy

DENSE = dict(
    repro_arch="phi4-mini-3.8b", torch_dtype="float32", hidden_size=64,
    num_attention_heads=4, num_key_value_heads=2, intermediate_size=96,
    num_hidden_layers=2, vocab_size=97, partial_rotary_factor=0.75,
    rope_theta=10000.0, rms_norm_eps=1e-6, tie_word_embeddings=True,
    max_position_embeddings=131072)

MOE = dict(
    repro_arch="deepseek-v2-lite-16b", torch_dtype="float32", hidden_size=64,
    num_attention_heads=4, num_key_value_heads=4, intermediate_size=96,
    num_hidden_layers=3, first_k_dense_replace=1, moe_layer_freq=1,
    kv_lora_rank=32, q_lora_rank=None, qk_nope_head_dim=16,
    qk_rope_head_dim=8, v_head_dim=16, n_routed_experts=8,
    n_shared_experts=2, num_experts_per_tok=3, moe_intermediate_size=24,
    vocab_size=97, rope_theta=10000, rms_norm_eps=1e-6,
    tie_word_embeddings=False, max_position_embeddings=163840,
    moe_capacity_factor=1.25, moe_group_tokens=2048)


def config(base, **kw):
    out = copy.deepcopy(base)
    out.update(kw)
    return out


def traffic(workload="forward", prompt_len=12, gen_tokens=0, b_max=4,
            rate=60.0):
    return dict(workload=workload, prompt_len=prompt_len,
                gen_tokens=gen_tokens, b_max=b_max, policy="capped",
                arrivals="poisson", rate_rps=rate)


def cell(config_name="tiny", traffic_name="tiny", requests=6,
         limits=None):
    return dict(name="tiny-cell", config=config_name, traffic=traffic_name,
                driver="serve", chips=1,
                trace={"seconds": 0.3},
                check={"requests": requests,
                       "limits": limits or {"gap_max": 0.05,
                                            "logit_err_p50": 0.05}})


def deep(base):
    """A test-sized model deep and wide enough for the float8 control's
    error to build up as it does at the cells' sizes: 16 layers of 256,
    a vocabulary of 4,096, float32."""
    kw = dict(hidden_size=256, num_hidden_layers=16, vocab_size=4096,
              intermediate_size=512)
    if "kv_lora_rank" in base:
        kw.update(kv_lora_rank=128, moe_intermediate_size=128,
                  qk_nope_head_dim=32, v_head_dim=32, qk_rope_head_dim=16)
    return config(base, **kw)
