"""Training (counterpart of `aura_snn_rag_tpu.training`): the loss, the LR
schedule, the optimizer, the trainer with replay, sleep phase and EWC,
checkpoints, online learning (Oja, STDP, whitener, NLMS), the STDP
dictionary, the tokenizer and the data loaders."""

from aura_snn_rag_tpu_torch.training.losses import (  # noqa: F401
    hippocampal_loss, perplexity)
from aura_snn_rag_tpu_torch.training.schedule import (  # noqa: F401
    warmup_cosine_schedule)
from aura_snn_rag_tpu_torch.training.optim import (  # noqa: F401
    AdamWState, ClippedAdamW)
from aura_snn_rag_tpu_torch.training.trainer import (  # noqa: F401
    EWCConsolidator, ReplayBuffer, Trainer, TrainState)
from aura_snn_rag_tpu_torch.training.checkpoint import (  # noqa: F401
    CheckpointManager)
