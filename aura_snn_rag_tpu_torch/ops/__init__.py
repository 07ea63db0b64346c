"""Ops of the port: the spiking and encoding ops the LM runs (surrogate
spikes, GIF neuron, place cells, theta-gamma encoding), the neurons and
addition-only maths of the brain zones (LIF, Izhikevich and its presets,
AdEx, `maths`), the spike-aware ops and spike bridges (`snn_ops`,
`spike_bridge`), the leaky integrator of the STDP learner, and the
kernels (`cuda/`): hand-written CUDA for Hopper, each beside its plain
PyTorch version."""

from aura_snn_rag_tpu_torch.ops.surrogate import (  # noqa: F401
    heaviside_spike, multi_bit_spike)
from aura_snn_rag_tpu_torch.ops.neurons import (  # noqa: F401
    AdExParams, GIFParams, IzhikevichParams, LIFParams, adex_params,
    adex_scan, gif_params, gif_scan, gif_scan_const, izhikevich_params,
    izhikevich_scan, leaky_integrate, lif_params, lif_scan)
from aura_snn_rag_tpu_torch.ops.place_cells import (  # noqa: F401
    place_cell_encode, sparse_place_code)
from aura_snn_rag_tpu_torch.ops.theta_gamma import (  # noqa: F401
    ThetaGammaParams, init_theta_gamma, theta_gamma_encoding)
