"""Shared helpers for the port's parity tests, and the config/state tests.

The port (`aura_snn_rag_tpu_torch`) is held against the JAX package on the
same inputs: numpy arrays made from a seed go into both, and results come
back as numpy. JAX runs under `jax.default_matmul_precision("highest")`.
Sizes are small: M = 4096 rows, D = 128, K = 32 centroids (C = 256 slots
each at overprovision 2.0), probe P = 4, a 4-bucket overflow annex.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aura_snn_rag_tpu import config as jconfig
from aura_snn_rag_tpu.memory import engine as jengine
from aura_snn_rag_tpu.memory import state as jstate
import aura_snn_rag_tpu_torch as port
from aura_snn_rag_tpu_torch.memory import engine as tengine
from aura_snn_rag_tpu_torch.memory import state as tstate

torch.set_num_threads(1)

SMALL = dict(max_memories=4096, feature_dim=128, k_centroids=32,
             probe_centroids=4, retrieve_k=5, bucket_overprovision=2.0,
             rebuild_lloyd_iters=2, overflow_buckets=4,
             n_place_cells=16, n_grid_cells=8, n_time_cells=4)


def configs(**kw):
    """The same configuration for both packages."""
    cfg = dict(SMALL, **kw)
    return jconfig.MemoryConfig(**cfg), port.MemoryConfig(**cfg)


def highest():
    return jax.default_matmul_precision("highest")


def make_data(seed, n, d=128, n_centers=64, noise=1.0):
    """Clustered rows shaped like bench.py's make_data."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(n_centers, d).astype(np.float32) * 2.0
    feats = (centers[rng.randint(0, n_centers, n)]
             + noise * rng.randn(n, d).astype(np.float32))
    return feats


def queries_near(feats, seed, n, noise=0.5):
    rng = np.random.RandomState(seed)
    pick = rng.randint(0, len(feats), n)
    return feats[pick] + noise * rng.randn(n, feats.shape[1]).astype(
        np.float32)


def to_port(jax_state, device="cpu"):
    """A JAX MemoryState carried into the port through numpy."""
    return port.state_from_numpy(jax.tree.map(np.asarray, jax_state), device)


def np_state(state):
    """Either package's MemoryState as numpy (bf16 as f32)."""
    if isinstance(state, tstate.MemoryState):
        return tstate.state_to_numpy(state)
    return jstate.MemoryState(*[np.asarray(jnp.asarray(x).astype(
        jnp.float32) if x.dtype == jnp.bfloat16 else x) for x in state])


def built_jax_state(jcfg, feats, seed=0):
    """bulk_load + rebuild in the JAX package."""
    with highest():
        st = jstate.init_memory_state(jcfg)
        st = jengine.bulk_load(jcfg, st, jnp.asarray(feats),
                               jnp.zeros((len(feats), 2), jnp.float32))
        return jengine.rebuild_centroids(jcfg, st, jax.random.PRNGKey(seed))


def assert_topk_match(idx_a, sc_a, idx_b, sc_b, tol):
    """Scores agree within `tol`; indices agree wherever the score is more
    than `tol` away from every other score in its row (topk does not fix
    the order of ties)."""
    idx_a, sc_a, idx_b, sc_b = (np.asarray(x) for x in (idx_a, sc_a,
                                                        idx_b, sc_b))
    np.testing.assert_allclose(sc_a, sc_b, rtol=0, atol=tol)
    for r in range(sc_a.shape[0]):
        for j in range(sc_a.shape[1]):
            others = np.delete(sc_b[r], j)
            if others.size == 0 or np.min(np.abs(others - sc_b[r, j])) > tol:
                assert idx_a[r, j] == idx_b[r, j], (r, j, idx_a[r], idx_b[r])


def result_np(res):
    """(indices, scores, features) of either package as numpy."""
    return tuple(np.asarray(x.cpu() if torch.is_tensor(x) else x)
                 for x in res)


@functools.lru_cache(maxsize=None)
def shared_bank(coarse):
    """A live, partly decayed bank with varied ages and locations."""
    jcfg, _ = configs(coarse_dtype=coarse)
    feats = make_data(11, 4096)
    rng = np.random.RandomState(12)
    locs = rng.randn(4096, 2).astype(np.float32) * 3
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats[:3900]),
                               jnp.asarray(locs[:3900]))
        js = jengine.rebuild_centroids(jcfg, js, jax.random.PRNGKey(1))
        js = jengine.decay_memories(js, 0.1)
        js = jengine.tick(js, 900.0)
        js = jengine.write_memories(jcfg, js, jnp.asarray(feats[3900:]),
                                    jnp.asarray(locs[3900:]))
    return jax.tree.map(np.asarray, js), feats


def bank_pair(coarse, **kw):
    """Both packages' copies of `shared_bank` under one configuration."""
    arrays, feats = shared_bank(coarse)
    jcfg, tcfg = configs(coarse_dtype=coarse, **kw)
    js = jax.tree.map(jnp.asarray, arrays)
    return jcfg, tcfg, js, port.state_from_numpy(arrays, "cpu"), feats


def spy_ivf_kernels(monkeypatch):
    """Records which IVF kernel wrapper the port's `retrieve` calls."""
    calls = []
    for name in ("ivf_retrieve_fused", "ivf_candidates", "ivf_topk_scores",
                 "ivf_scan_scores"):
        fn = getattr(tengine, name)

        def wrapped(*a, _fn=fn, _name=name, **kw):
            calls.append(_name)
            return _fn(*a, **kw)
        monkeypatch.setattr(tengine, name, wrapped)
    return calls


def retrieve_both(jcfg, tcfg, js, ts, q, qloc, k):
    """`retrieve` of both packages on the same queries, as numpy."""
    with highest():
        jr = result_np(jengine.retrieve(
            jcfg, js, jnp.asarray(q),
            None if qloc is None else jnp.asarray(qloc), k))
    tr = result_np(port.retrieve(
        tcfg, ts, torch.from_numpy(q),
        None if qloc is None else torch.from_numpy(qloc), k))
    return jr, tr


def ivf_kernel_inputs(seed, K=32, C=256, D=128, B=3, P=4, M=4096,
                      probes=None):
    """Inputs of the IVF kernels for both packages: a bf16 clustered store
    [K, C, D], its aux rows [K, 8, C] with 30% dead entries, a bank
    [M, D], normalised queries [B, D] and P distinct probes per query
    (drawn by `probes(rng)` when given, e.g. `crowded_probes`).
    Returns (jax arrays, torch tensors), each (clustered, aux, features,
    qn, top_c)."""
    rng = np.random.RandomState(seed)
    cl = rng.randn(K, C, D).astype(np.float32)
    cl /= np.linalg.norm(cl, axis=-1, keepdims=True)
    cl16 = jnp.asarray(cl, jnp.bfloat16)
    aux = np.zeros((K, 8, C), np.float32)
    aux[:, 0] = rng.rand(K, C) * 0.5 + 0.25
    aux[:, 1] = rng.rand(K, C) * 0.2
    aux[:, 1][rng.rand(K, C) < 0.3] = -1e30                  # dead entries
    aux[:, 2] = rng.randint(0, M, (K, C))
    feats = rng.randn(M, D).astype(np.float32)
    q = rng.randn(B, D).astype(np.float32)
    qn = q / np.linalg.norm(q, axis=1, keepdims=True)
    top_c = (np.stack([rng.choice(K, P, replace=False) for _ in range(B)])
             if probes is None else probes(rng)).astype(np.int32)
    jx = (cl16, jnp.asarray(aux), jnp.asarray(feats), jnp.asarray(qn),
          jnp.asarray(top_c))
    tx = (torch.from_numpy(np.array(cl16.astype(jnp.float32)))
          .to(torch.bfloat16), torch.from_numpy(aux),
          torch.from_numpy(feats), torch.from_numpy(qn),
          torch.from_numpy(top_c))
    return jx, tx


# --------------------------------------------------------------------------
# config and state
# --------------------------------------------------------------------------

def test_memory_config_fields_and_defaults_match():
    jf = {f.name: f.default for f in dataclasses.fields(jconfig.MemoryConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(port.MemoryConfig)}
    assert jf == tf
    for kw in ({}, SMALL, dict(max_memories=1_000_000, k_centroids=4096)):
        assert (jconfig.MemoryConfig(**kw).bucket_capacity
                == port.MemoryConfig(**kw).bucket_capacity)


@pytest.mark.parametrize("coarse", ["bf16", "int8"])
def test_init_memory_state_matches(coarse):
    jcfg, tcfg = configs(coarse_dtype=coarse)
    js = np_state(jstate.init_memory_state(jcfg))
    ts = port.init_memory_state(tcfg, device="cpu")
    assert ts.features_nb16.dtype == (torch.int8 if coarse == "int8"
                                      else torch.bfloat16)
    assert ts.clustered.dtype == torch.bfloat16
    tn = tstate.state_to_numpy(ts)
    for name, a, b in zip(jstate.MemoryState._fields, js, tn):
        assert a.shape == b.shape, name
        assert a.dtype == b.dtype, (name, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_entry_points_default_to_cuda():
    _, tcfg = configs()
    lm = port.get_debug_config().model
    if torch.cuda.is_available():
        assert port.init_memory_state(tcfg).features.is_cuda
        assert port.HippocampalTransformer(lm).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.init_memory_state(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.HippocampalFormation(tcfg)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.HippocampalTransformer(lm)
        with pytest.raises(RuntimeError, match="device='cpu'"):
            port.SNNRAGTransformer.create(lm, tcfg)


def test_state_numpy_round_trip_from_jax():
    jcfg, _ = configs(coarse_dtype="int8")
    feats = make_data(0, 1000)
    with highest():
        js = jengine.bulk_load(jcfg, jstate.init_memory_state(jcfg),
                               jnp.asarray(feats),
                               jnp.zeros((1000, 2), jnp.float32))
    ts = to_port(js)
    assert ts.features_nb16.dtype == torch.int8
    assert ts.clustered.dtype == torch.bfloat16
    for name, a, b in zip(jstate.MemoryState._fields, np_state(js),
                          tstate.state_to_numpy(ts)):
        np.testing.assert_array_equal(a, b, err_msg=name)
    back = tstate.state_from_numpy(tstate.state_to_numpy(ts), "cpu")
    for a, b in zip(ts, back):
        assert a.dtype == b.dtype and torch.equal(a, b)


# --------------------------------------------------------------------------
# brain zones: spikes of both packages, to compare outputs where they agree
# --------------------------------------------------------------------------

ZONE_TOL = 1e-5         # f32 zone outputs where every spike agrees
# a spike flips where a potential lands within an ulp of its threshold:
# ~1e-6 of the Izhikevich entries at the zone's drive, fewer for LIF
FLIP_FRACTION = 1e-4


@functools.partial(jax.jit, static_argnums=(1,))
def _jax_population(w, config, x, homeo):
    from aura_snn_rag_tpu.ops.maths import addition_linear
    from aura_snn_rag_tpu.zones.brain_zone import spiking_group_forward
    from aura_snn_rag_tpu_torch.zones.brain_zone import group_sizes
    cur = addition_linear(x, w - 0.1)
    mu = cur.mean(axis=-1, keepdims=True)
    sd = cur.std(axis=-1, keepdims=True) + 1e-6
    cur = jnp.tanh((cur - mu) / sd)
    cur = jnp.broadcast_to(cur[..., None, :], cur.shape[:-1]
                           + (config.timesteps, config.n_neurons))
    spikes, mems, off = [], [], 0
    for ncfg, size in zip(config.neuron_configs, group_sizes(config)):
        if size <= 0:
            continue
        sp, mem = spiking_group_forward(ncfg, cur[..., off:off + size],
                                        homeo[off:off + size])
        spikes.append(sp)
        mems.append(mem / (30.0 if ncfg.neuron_type in
                           ("izhikevich", "adex") else 1.0))
        off += size
    return jnp.concatenate(spikes, -1), jnp.concatenate(mems, -1)


def jax_zone_population(zone_params, config, x, homeo_i=None):
    """A JAX `NeuromorphicBrainZone`'s spikes [B, T, N] and membranes
    [B, N] (numpy), computed by the JAX package's own functions in the
    order its zone runs them (the zone returns only their statistics).
    Jitted, as the tests jit the zone itself: eager JAX compiles each
    op of the 128-step scans anew."""
    n = config.n_neurons
    homeo = jnp.zeros((n,)) if homeo_i is None else jnp.asarray(homeo_i)
    w = jnp.asarray(zone_params["params"]["input_proj"]["weight_patterns"])
    sp, mem = _jax_population(w, config, jnp.atleast_2d(jnp.asarray(x)),
                              homeo)
    return np.asarray(sp), np.asarray(mem)


def zone_flips(zone_params, config, tzone, x, homeo_i=None):
    """[B, T, N] where the two packages' zones spike differently on x
    (asserting the flips stay rare), and the JAX spikes."""
    jsp, _ = jax_zone_population(zone_params, config, x, homeo_i)
    with torch.no_grad():
        tsp, _ = tzone.population(
            torch.atleast_2d(torch.as_tensor(np.asarray(x, np.float32))),
            None if homeo_i is None else torch.as_tensor(
                np.asarray(homeo_i, np.float32)))
    flips = jsp != tsp.numpy()
    assert flips.mean() <= FLIP_FRACTION, flips.mean()
    return flips, jsp


def assert_rows_match(got, want, flipped_rows, tol=ZONE_TOL):
    """Rows of `got` and `want` equal within `tol` where no spike of the
    row flipped."""
    got, want = np.asarray(got), np.asarray(want)
    keep = ~np.asarray(flipped_rows)
    assert keep.any()
    np.testing.assert_allclose(got[keep], want[keep], rtol=0, atol=tol)


# --------------------------------------------------------------------------
# language zones: the spikes of every stage in both packages, to compare
# outputs on the rows where they agree
# --------------------------------------------------------------------------

def intermediates(tree, *path):
    """A captured flax intermediate's value (`capture_intermediates`)."""
    for key in path:
        tree = tree[key]
    return tree["__call__"][0]


class Tap:
    """Records the outputs of port submodules by name (forward hooks)."""

    def __init__(self, **modules):
        self.out = {}
        self._handles = [
            m.register_forward_hook(
                lambda _, __, out, name=name: self.out.__setitem__(name, out))
            for name, m in modules.items()]

    def remove(self):
        for h in self._handles:
            h.remove()


def jax_poisson(rng, combined_shape, timesteps):
    """The uniform draw of the JAX package's Poisson bridge for a [B, D]
    input under `rng`, as numpy [B, timesteps, D]."""
    B, D = combined_shape
    return np.asarray(jax.random.uniform(rng, (B, timesteps, D)))


def patched_poisson(u):
    """A stand-in for the port's `continuous_to_spikes` that compares the
    JAX package's uniform draw `u` against sigmoid(x), recording its
    spikes."""
    drawn = {}

    def fn(x, timesteps, generator=None, mode="poisson"):
        assert mode == "poisson" and u.shape[1] == timesteps
        s = (torch.from_numpy(u).to(x.device)
             < torch.sigmoid(x)[..., None, :]).to(x.dtype)
        drawn["spikes"] = s.detach()
        return s
    return fn, drawn


@functools.partial(jax.jit, static_argnums=(2,))
def _jax_expert_spikes(experts, x, shared):
    from aura_snn_rag_tpu.ops.neurons import gif_params, gif_scan
    gp = gif_params(levels=8)

    def one(p, xe):
        s1, _ = gif_scan(gp, xe @ p["syn1"]["kernel"] + p["syn1"]["bias"])
        s2, _ = gif_scan(gp, s1 @ p["syn2"]["kernel"] + p["syn2"]["bias"])
        return s1, s2
    return jax.vmap(one, in_axes=(0, None if shared else 0))(experts, x)


def _flagged(jsp, tsp, axes):
    """Entries where two spike tensors differ, held to FLIP_FRACTION;
    returns (any flip over `axes`, number of flips)."""
    flips = np.asarray(jsp) != np.asarray(tsp)
    assert flips.mean() <= FLIP_FRACTION, flips.mean()
    return flips.any(axis=axes), int(flips.sum())


def zone_spike_flips(zone_params, jinter, tap, tzone, ids, u, drawn,
                     dense):
    """Rows [B] of a `FullLanguageZone` call where a spike of the two
    packages differs (encoder, each expert's two GIF layers, the Poisson
    draw or the decoder), asserting that flips stay rare, and the JAX
    encoder's spikes and dispatch plan. `zone_params` and `jinter` are
    the zone's flax params and captured intermediates, `tap` a `Tap` of
    the port zone's encoder_proj, bank.experts.syn1/syn2 and
    decoder_proj, `u` and `drawn` the Poisson draw and what the patched
    port bridge made of it."""
    from aura_snn_rag_tpu.models import language_zone as jlz
    from aura_snn_rag_tpu.models import prosody as jp
    from aura_snn_rag_tpu.ops.neurons import gif_params, gif_scan
    from aura_snn_rag_tpu_torch.models import prosody as tp
    from aura_snn_rag_tpu_torch.ops import neurons as tn
    gp, tgp = gif_params(levels=8), tn.gif_params(levels=8)
    B, T = ids.shape
    jids = jnp.asarray(ids)
    # encoder
    jgains, _ = jp.prosody_attention_gains(jids)
    jenc, _ = jp.prosody_gif_scan(gp, intermediates(jinter, "encoder_proj"),
                                  jgains)
    tgains, _ = tp.prosody_attention_gains(torch.from_numpy(ids))
    with torch.no_grad():
        tenc, _ = tp.prosody_gif_scan(tgp, tap.out["encoder_proj"], tgains)
    rows, n = _flagged(jenc, tenc.numpy(), (1, 2))
    flips = n
    # experts: every expert on every row (dense), or capacity slots
    routing = intermediates(jinter, "router")
    experts = zone_params["bank"]["experts"]
    if dense:
        js1, js2 = _jax_expert_spikes(experts, jenc, True)
        plan = None
    else:
        E = experts["syn1"]["kernel"].shape[0]
        k = routing["indices"].shape[-1]
        cap = max(1, int(tzone.bank.capacity_factor * B * k / E))
        plan, _, _ = jlz.topk_dispatch(routing["indices"],
                                       routing["weights"], E, cap)
        js1, js2 = _jax_expert_spikes(
            experts, jnp.einsum("bec,btd->ectd", plan, jenc), False)
    with torch.no_grad():
        E, N = js1.shape[:2]
        ts1, _ = tn.gif_scan(tgp, tap.out["syn1"].reshape(E, N, T, -1))
        ts2, _ = tn.gif_scan(tgp, tap.out["syn2"].reshape(E, N, T, -1))
    for jsp, tsp in ((js1, ts1), (js2, ts2)):
        slot_rows, n = _flagged(jsp, tsp.numpy(), (2, 3))       # [E, N]
        flips += n
        if dense:
            rows |= slot_rows.any(axis=0)
        else:
            rows |= np.einsum("bec,ec->b", np.asarray(plan),
                              slot_rows.astype(np.float32)) > 0
    # the Poisson draw and the decoder
    bank_out = intermediates(jinter, "bank")
    if dense:                   # the zone's combine, as the JAX zone runs it
        w = jax.vmap(lambda wv, idx, val: wv.at[idx].add(val))(
            jnp.zeros(bank_out.shape[:2]), routing["indices"],
            routing["weights"])
        combined = jnp.einsum("be,bed->bd", w, bank_out)
    else:
        combined = bank_out[0]
    jdraw = u < np.asarray(jax.nn.sigmoid(combined))[:, None, :]
    r, n = _flagged(jdraw, drawn["spikes"].numpy() > 0, (1, 2))
    rows |= r
    flips += n
    jdec, _ = gif_scan(gp, intermediates(jinter, "decoder_proj"))
    with torch.no_grad():
        tdec, _ = tn.gif_scan(tgp, tap.out["decoder_proj"])
    r, n = _flagged(jdec, tdec.numpy(), (1, 2))
    rows |= r
    return rows, flips + n, np.asarray(jenc), plan
