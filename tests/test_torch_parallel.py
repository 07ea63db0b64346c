"""The port's launcher seam and meshes (`parallel/distributed.py`,
`parallel/mesh.py`), against the JAX package's
`tests/parallel/test_distributed.py`: the single-process no-op path in
this process, and two processes that form a gloo group from the launcher
variables (AURA_COORDINATOR, AURA_NUM_PROCESSES, AURA_PROCESS_ID), build
meshes over both, cut a global batch and assemble it back with a
collective."""

import numpy as np
import pytest
import torch

from aura_snn_rag_tpu.parallel import distributed as jdist
from aura_snn_rag_tpu_torch.parallel import distributed as tdist
from tests.test_torch_ranks import spawn

ENV = ("AURA_COORDINATOR", "AURA_NUM_PROCESSES", "AURA_PROCESS_ID", "RANK")


@pytest.fixture()
def no_launcher_env(monkeypatch):
    for name in ENV:
        monkeypatch.delenv(name, raising=False)


def test_single_process_initialize_is_a_noop(no_launcher_env):
    assert tdist.initialize() is False
    assert jdist.initialize() is False
    assert not tdist.is_multiprocess()
    assert tdist.local_batch_slice(32) == slice(0, 32) \
        == jdist.local_batch_slice(32)


def test_mesh_without_a_group_raises(no_launcher_env):
    with pytest.raises(RuntimeError, match="initialize"):
        tdist.global_mesh(1)


def test_initialize_needs_the_whole_address(no_launcher_env):
    with pytest.raises(ValueError, match="process id"):
        tdist.initialize("localhost:1234", num_processes=2)


def test_initialize_on_cuda_without_a_card_raises(no_launcher_env):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tdist.initialize("localhost:1234", 2, 0)


IDS = np.random.RandomState(9).randint(0, 512, (2, 4, 16)).astype(np.int32)


@pytest.fixture(scope="module")
def two(tmp_path_factory):
    return spawn("two_process", 2, tmp_path_factory.mktemp("ranks"),
                 {"ids": IDS}, via_env=True)


def test_two_process_group_from_the_launcher_variables(two):
    for o in two:
        assert bool(o["initialize_again"]) and bool(o["multiprocess"])


def test_two_process_meshes(two):
    """'model' innermost, 'replica' outermost, as JAX lays out devices."""
    for o in two:
        assert o["mesh_shape"].tolist() == [2, 1]
        assert o["model_mesh_shape"].tolist() == [1, 2]
        assert o["multislice_shape"].tolist() == [2, 1, 1]
        assert o["make_mesh_shape"].tolist() == [2, 1]


def test_two_process_batch_slices_and_global_array(two):
    full = np.arange(8, dtype=np.float32)[:, None]
    for rank, o in enumerate(two):
        assert o["slice"].tolist() == [4 * rank, 4 * rank + 4]
        assert o["global_shape"].tolist() == [8, 1]
        assert int(o["start"]) == 4 * rank
        assert float(o["total"]) == float(full.sum())
        np.testing.assert_array_equal(o["shard_batch"],
                                      full[4 * rank:4 * rank + 4])


def test_model_parallel_axes_raise(two):
    """A 'model', 'seq' or 'stage' axis of 2 in `shard_to_mesh`, and
    `shard_params` over a 'model' axis of 2: none raises any longer (their
    parity with JAX is held in `test_torch_mp_trainer.py`,
    `test_torch_tp.py`, `test_torch_ring.py` and `test_torch_pp.py`)."""
    for o in two:
        assert o["model_parallel_raises"].tolist() == [False] * 4


def test_replicated_bank_equals_one_process(two):
    """`shard_to_mesh(shard_memory=False)`: each rank keeps the whole bank
    and writes the whole batch, so two ranks take the one-process
    trainer's steps (losses within `test_torch_trainer.py`'s LOSS_RTOL;
    parameters within 2 x lr per step, as its chunk test holds them: the
    gradient mean sums in another order, and Adam turns a gradient at the
    noise level into a full step), and every rank's bank holds every
    row."""
    import aura_snn_rag_tpu_torch as port
    from tests.test_torch_ranks import replicated_bank_config
    tt = port.Trainer(replicated_bank_config(), seed=0, device="cpu")
    losses = [tt.train_step(x, x)["loss"] for x in IDS]
    for o in two:
        np.testing.assert_allclose(o["replicated/losses"], losses,
                                   rtol=2e-6)
        np.testing.assert_allclose(
            o["replicated/flat"], tt.optimizer.flat.detach().numpy(),
            rtol=0, atol=2 * len(IDS) * tt.config.training.lr)
        assert int(o["replicated/count"]) == IDS.shape[0] * IDS.shape[1]
    np.testing.assert_array_equal(two[0]["replicated/flat"],
                                  two[1]["replicated/flat"])


def test_checkpoint_on_a_mesh_of_some_ranks(two):
    """`shard_to_mesh`, a step and a sharded-bank checkpoint on a mesh of
    rank 1 alone: the broadcast, the bank's gather and the barriers stay
    inside the mesh, so rank 0, which calls none of them, hangs nothing,
    and the round trip is bit-equal."""
    assert not any(k.startswith("subset/") for k in two[0])
    assert int(two[1]["subset/restored_step"]) == 1
    assert two[1]["subset/restored_equal"].all()
