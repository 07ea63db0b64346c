"""Ops of the port: the spiking and encoding ops the LM runs (surrogate
spike, GIF neuron, place cells, theta-gamma encoding), the leaky
integrator of the STDP learner, and the kernels
(`cuda/`): hand-written CUDA for Hopper, each beside its plain PyTorch
version."""

from aura_snn_rag_tpu_torch.ops.surrogate import multi_bit_spike  # noqa: F401
from aura_snn_rag_tpu_torch.ops.neurons import (  # noqa: F401
    GIFParams, gif_params, gif_scan, gif_scan_const, leaky_integrate)
from aura_snn_rag_tpu_torch.ops.place_cells import (  # noqa: F401
    place_cell_encode, sparse_place_code)
from aura_snn_rag_tpu_torch.ops.theta_gamma import (  # noqa: F401
    ThetaGammaParams, init_theta_gamma, theta_gamma_encoding)
