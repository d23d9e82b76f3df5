"""Training of the port's models on one device: AdamW, the (chunked)
cross-entropy, remat, microbatching and checkpoints."""
from repro_torch.train.loop import (  # noqa: F401
    cross_entropy,
    loss_fn,
    make_train_step,
    train,
)
from repro_torch.train.optimizer import (  # noqa: F401
    AdamWConfig,
    AdamWState,
    init_state,
)
