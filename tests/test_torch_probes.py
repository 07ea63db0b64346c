"""Probe lists in which many queries share clusters, for the IVF kernels'
tests: the inputs that kernels B and D's cluster-major coarse pass takes
(the CPU parity tests against the Pallas kernels in
`test_torch_ivf.py` / `test_torch_ivf_v2.py`, and the card tests in
`test_torch_cuda.py`, which import no JAX). Numpy only.
"""

import numpy as np
import pytest


def crowded_probes(rng, K, B, P, hot=0, span=None):
    """[B, P] int32 cluster ids, distinct within each row (as `torch.topk`
    over the centroids gives them): every row probes clusters 0 .. hot-1
    (`hot` clusters shared by every query), then P - hot distinct ones drawn
    from hot .. span-1 (span defaults to K; a smaller span leaves clusters
    span .. K-1 unprobed), each row in its own random order."""
    span = K if span is None else span
    if not 0 <= hot <= P <= span <= K:
        raise ValueError(f"hot={hot}, P={P}, span={span}, K={K}")
    rows = []
    for _ in range(B):
        ids = np.concatenate([np.arange(hot),
                              hot + rng.choice(span - hot, P - hot,
                                               replace=False)])
        rows.append(ids[rng.permutation(P)])
    return np.stack(rows).astype(np.int32)


@pytest.mark.parametrize("K,B,P,hot,span", [
    (16, 32, 4, 0, None), (16, 32, 4, 4, None), (32, 150, 4, 1, None),
    (64, 40, 8, 0, 16)])
def test_crowded_probes_are_distinct_per_row_and_shared(K, B, P, hot, span):
    top_c = crowded_probes(np.random.RandomState(K + B), K, B, P, hot, span)
    assert top_c.shape == (B, P) and top_c.dtype == np.int32
    for row in top_c:
        assert len(set(row.tolist())) == P
        assert set(range(hot)) <= set(row.tolist())
    span = K if span is None else span
    assert top_c.min() >= 0 and top_c.max() < span
    # crowded: more pairs than the probed clusters
    assert top_c.size > len(np.unique(top_c))


def test_crowded_probes_reject_what_cannot_be_drawn():
    rng = np.random.RandomState(0)
    with pytest.raises(ValueError):
        crowded_probes(rng, 16, 2, 5, hot=6)
    with pytest.raises(ValueError):
        crowded_probes(rng, 16, 2, 5, span=4)
