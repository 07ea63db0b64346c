"""Training (counterpart of `aura_snn_rag_tpu.training`): the loss, the LR
schedule, the optimizer, the trainer with replay, sleep phase and EWC,
the tokenizer and the data loaders. Checkpoints, online learning and
the STDP dictionary come in a later slice."""

from aura_snn_rag_tpu_torch.training.losses import (  # noqa: F401
    hippocampal_loss, perplexity)
from aura_snn_rag_tpu_torch.training.schedule import (  # noqa: F401
    warmup_cosine_schedule)
from aura_snn_rag_tpu_torch.training.optim import (  # noqa: F401
    AdamWState, ClippedAdamW)
from aura_snn_rag_tpu_torch.training.trainer import (  # noqa: F401
    EWCConsolidator, ReplayBuffer, Trainer, TrainState)
