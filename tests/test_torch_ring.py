"""The port's ring attention (`parallel/ring_attention.py`) against the
JAX package's `sequence_sharded_attention`, the cases of
`tests/parallel/test_ring_attention.py`: the same q, k, v [B, L, H, Dh]
(numpy, seeded) through JAX's ring on the virtual CPU devices (jitted)
and through the port's on gloo ranks (`test_torch_ranks.spawn`), each
rank holding its rows, its chunk of the sequence and its heads:
- a 'seq' axis of 2 and of 4, causal; of 4, non-causal;
- ('data', 'seq') of (2, 2): the ring composes with a batch axis;
- ('seq', 'model') of (2, 2): heads sharded over 'model' inside the ring
  (sequence x tensor parallelism).
Outputs within the JAX tests' bound (rtol 2e-4, atol 2e-5) of JAX's,
and the gradients of mean((out - tgt)^2) with respect to q, k and v
within rtol 1e-4, atol 1e-5, in f32; each rank's loss is its elements'
share, so the ranks' losses add up to JAX's one loss.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from aura_snn_rag_tpu.parallel.ring_attention import (
    sequence_sharded_attention)
from tests.test_torch_ranks import spawn

torch.set_num_threads(1)

B, L, H, DH = 4, 32, 4, 16
OUT_TOL = dict(rtol=2e-4, atol=2e-5)      # tests/parallel/test_ring_attention
GRAD_TOL = dict(rtol=1e-4, atol=1e-5)
# (mesh shape, axis names, causal), by the world that runs them
CASES = {
    2: [((2,), ("seq",), True)],
    4: [((4,), ("seq",), True), ((4,), ("seq",), False),
        ((2, 2), ("data", "seq"), True), ((2, 2), ("seq", "model"), True)],
}


def inputs():
    rng = np.random.RandomState(7)
    mk = lambda: rng.randn(B, L, H, DH).astype(np.float32)
    return dict(q=mk(), k=mk(), v=mk(), tgt=mk())


@functools.lru_cache(maxsize=None)
def jax_ring(shape, names, causal):
    """JAX's output and q/k/v gradients on the same mesh."""
    x = inputs()
    mesh = Mesh(np.asarray(jax.devices()[:int(np.prod(shape))])
                .reshape(shape), names)
    kw = dict(mesh=mesh, seq_axis="seq",
              batch_axes=("data",) if "data" in names else (),
              head_axis="model" if "model" in names else None,
              causal=causal)
    tgt = jnp.asarray(x["tgt"])

    def loss(q, k, v):
        return jnp.mean((sequence_sharded_attention(q, k, v, **kw)
                         - tgt) ** 2)
    q, k, v = (jnp.asarray(x[n]) for n in "qkv")
    out = jax.jit(functools.partial(sequence_sharded_attention, **kw))(
        q, k, v)
    grads = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    return np.asarray(out), [np.asarray(g) for g in grads]


def assemble(outs, i, key, shape, names):
    """The whole [B, L, H, Dh] array from every rank's block."""
    n = dict(zip(names, shape))
    full = np.zeros((B, L, H, DH), np.float32)
    b, l, h = B // n.get("data", 1), L // n.get("seq", 1), \
        H // n.get("model", 1)
    for o in outs:
        d, s, m = o[f"{i}/coords"]
        full[d * b:(d + 1) * b, s * l:(s + 1) * l, m * h:(m + 1) * h] = \
            o[f"{i}/{key}"]
    return full


@pytest.fixture(scope="module", params=sorted(CASES))
def run(request, tmp_path_factory):
    world = request.param
    outs = spawn("tests.test_torch_mp_ranks:ring", world,
                 tmp_path_factory.mktemp("ring"), inputs(),
                 cases=CASES[world])
    return world, outs


def test_ring_matches_jax(run):
    world, outs = run
    for i, (shape, names, causal) in enumerate(CASES[world]):
        want, _ = jax_ring(shape, names, causal)
        np.testing.assert_allclose(assemble(outs, i, "out", shape, names),
                                   want, **OUT_TOL,
                                   err_msg=f"{names} {shape} {causal}")


def test_ring_gradients_match_jax(run):
    world, outs = run
    for i, (shape, names, causal) in enumerate(CASES[world]):
        _, grads = jax_ring(shape, names, causal)
        for key, want in zip(("gq", "gk", "gv"), grads):
            np.testing.assert_allclose(
                assemble(outs, i, key, shape, names), want, **GRAD_TOL,
                err_msg=f"{key} {names} {shape} {causal}")
