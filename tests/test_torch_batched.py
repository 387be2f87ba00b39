"""The port's batched path against the JAX package's, on the CPU.

The reference's vmap path (``JaxBackend.make_batched_operands``,
``execute_batch``, ``time_algorithm_batched``) against the port's on the
``torch`` and ``cuda`` backends (``device="cpu"``, so the kernels' plain
versions run): batched operands bit for bit, every algorithm of aatb,
abcd and abab at batch 3 against the reference's ``pallas`` backend
(Pallas interpret mode, its fused ``chain_gemm`` and ``gemm_syrk``
included) at rtol = atol = 1e-5, the tolerance of the reference's own
batched test (tests/test_backends.py), and each instance against the
port's per-instance ``execute``. Then the checks a batch goes through,
each launch rule at batch 1, and the schedule twins of the five matrix
kernels at a batch: each (instance, output tile, slice) covered exactly
once, and the grid's y and z within the card's 65,535 at batch 70,000.
"""

import itertools

import numpy as np
import pytest
import torch

from repro.core.backends import get_backend as ref_get_backend
from repro.core.expressions import get_spec as ref_get_spec
from repro_torch.core.backends import (CudaBackend, TorchBackend,
                                       operands_from_numpy)
from repro_torch.core.expressions import get_spec
from repro_torch.kernels import chain_gemm as kchain
from repro_torch.kernels import gemm as kgemm
from repro_torch.kernels import gemm_syrk as kfused
from repro_torch.kernels import ops
from repro_torch.kernels import symm as ksymm
from repro_torch.kernels import syrk as ksyrk

TOL = dict(rtol=1e-5, atol=1e-5)
BATCH = 3
POINTS = {"aatb": (16, 8, 12), "abcd": (16, 8, 12, 8, 16),
          "abab": (16, 8, 12)}
SWEEP_DIMS = (400, 800, 1200)


def _port_backends():
    return {"torch": TorchBackend(device="cpu", seed=0, reps=1),
            "cuda": CudaBackend(device="cpu", seed=0, reps=1, tuning=None)}


@pytest.mark.parametrize("name", sorted(POINTS))
def test_batched_operands_equal_the_reference_bit_for_bit(name):
    ref = ref_get_backend("jax", seed=0)
    port = TorchBackend(device="cpu", seed=0)
    point = POINTS[name]
    for ra, pa in zip(ref_get_spec(name).algorithms(point),
                      get_spec(name).algorithms(point)):
        assert ra.name == pa.name
        want = ref.make_batched_operands(ra, BATCH)
        got = port.make_batched_operands(pa, BATCH)
        assert want.keys() == got.keys()
        single = port.make_operands(pa)
        ref_single = ref.make_operands(ra)
        for base, arr in want.items():
            np.testing.assert_array_equal(got[base].numpy(), np.asarray(arr))
            assert got[base].shape[0] == BATCH
            # No leading axis: the draw is the one it always was.
            np.testing.assert_array_equal(single[base].numpy(),
                                          np.asarray(ref_single[base]))
        assert port.num_inputs(pa) == ref.num_inputs(ra)


@pytest.mark.parametrize("name", sorted(POINTS))
def test_execute_batch_matches_pallas_and_each_instance(name):
    ref = ref_get_backend("pallas", seed=0, tuning=None)
    point = POINTS[name]
    backends = _port_backends()
    for ra, pa in zip(ref_get_spec(name).algorithms(point),
                      get_spec(name).algorithms(point)):
        ref_ops = ref.make_batched_operands(ra, BATCH)
        want = np.asarray(ref.execute_batch(ra, ref_ops))
        operands = operands_from_numpy(
            {k: np.asarray(v) for k, v in ref_ops.items()}, "cpu")
        for label, be in backends.items():
            got = be.execute_batch(pa, operands)
            assert got.shape[0] == BATCH, (label, pa.name)
            np.testing.assert_allclose(got.numpy(), want, **TOL,
                                       err_msg=f"{label} {pa.name}")
            built = be.build_batched(pa)(*be._args(pa, operands))
            np.testing.assert_array_equal(built.numpy(), got.numpy())
            for i in range(BATCH):
                single = be.execute(pa, {k: v[i] for k, v in operands.items()})
                np.testing.assert_allclose(got[i].numpy(), single.numpy(),
                                           **TOL)


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_time_algorithm_batched_runs(backend):
    be = _port_backends()[backend]
    alg = get_spec("aatb").algorithms(POINTS["aatb"])[0]
    assert be.time_algorithm_batched(alg, batch=2, reps=1) >= 0.0


@pytest.mark.parametrize("backend", ["torch", "cuda"])
def test_batched_path_takes_one_batch_axis_of_one_size(backend):
    be = _port_backends()[backend]
    alg = get_spec("aatb").algorithms(POINTS["aatb"])[1]
    ops_ = be.make_batched_operands(alg, BATCH)
    two_axes = {k: v.unsqueeze(0).expand(2, *v.shape) for k, v in ops_.items()}
    with pytest.raises(ValueError, match=rf"backend '{backend}' "
                                         r".*one leading batch dim"):
        be.execute_batch(alg, two_axes)
    with pytest.raises(ValueError, match="one leading batch dim"):
        be.time_algorithm_batched(alg, operands=two_axes, reps=1)
    unequal = dict(ops_)
    base = next(iter(unequal))
    unequal[base] = unequal[base][:2]
    if len(unequal) > 1:
        with pytest.raises(ValueError, match="batch dim mismatch"):
            be.execute_batch(alg, unequal)
    with pytest.raises(ValueError, match="one leading batch dim"):
        be.build_batched(alg)(*be._args(alg, {k: v[0] for k, v in
                                              ops_.items()}))


def test_kernel_checks_take_a_batch_and_name_the_kernel():
    z = torch.zeros
    for kernel, call in (
            ("gemm", lambda: ops.gemm(z(2, 3, 4, 5), z(2, 3, 5, 4))),
            ("syrk", lambda: ops.syrk(z(2, 3, 4, 5))),
            ("symm", lambda: ops.symm(z(2, 3, 4, 4), z(2, 3, 4, 5))),
            ("chain_gemm", lambda: ops.chain_gemm(z(2, 3, 4), z(2, 4, 5),
                                                  z(2, 1, 5, 6))),
            ("gemm_syrk", lambda: ops.gemm_syrk(z(1, 2, 3, 4), z(1, 2, 4, 5))),
            ("tri2full", lambda: ops.tri2full(z(2, 2, 4, 4)))):
        with pytest.raises(ValueError, match=rf"^{kernel}: .* must be a "
                                             r"matrix or a batch"):
            call()
    for kernel, call in (
            ("gemm", lambda: ops.gemm(z(3, 4, 5), z(2, 5, 4))),
            ("gemm", lambda: ops.gemm(z(3, 4, 5), z(5, 4))),
            ("symm", lambda: ops.symm(z(3, 4, 4), z(2, 4, 5))),
            ("chain_gemm", lambda: ops.chain_gemm(z(3, 4, 5), z(3, 5, 6),
                                                  z(1, 6, 2))),
            ("gemm_syrk", lambda: ops.gemm_syrk(z(3, 4, 5), z(4, 5, 6)))):
        with pytest.raises(ValueError, match=rf"^{kernel}: batch dim mismatch"):
            call()
    # The inner dims' messages are the matrices' own, whatever the batch.
    with pytest.raises(ValueError, match=r"contraction dim k.*A.shape\[1\]=64"):
        ops.gemm(z(2, 128, 64), z(2, 128, 128))
    with pytest.raises(ValueError, match="symmetric dim m"):
        ops.symm(z(2, 128, 100), z(2, 128, 8))
    with pytest.raises(ValueError, match="square dim"):
        ops.tri2full(z(2, 8, 9))


def test_batched_kernel_entry_points_on_cpu_take_the_plain_version():
    rng = np.random.default_rng(5)
    a = torch.from_numpy(rng.standard_normal((BATCH, 7, 5))).float()
    b = torch.from_numpy(rng.standard_normal((BATCH, 5, 6))).float()
    c = torch.from_numpy(rng.standard_normal((BATCH, 6, 4))).float()
    s = torch.from_numpy(rng.standard_normal((BATCH, 7, 7))).float()
    before = ops.launch_counts()
    for i in range(BATCH):
        torch.testing.assert_close(ops.gemm(a, b)[i], a[i] @ b[i])
        torch.testing.assert_close(ops.syrk(a)[i], torch.tril(a[i] @ a[i].T))
        torch.testing.assert_close(ops.symm(s, a)[i],
                                   ops.symm(s[i], a[i]))
        torch.testing.assert_close(ops.chain_gemm(a, b, c)[i],
                                   (a[i] @ b[i]) @ c[i])
        torch.testing.assert_close(ops.gemm_syrk(a, b)[i],
                                   ops.gemm_syrk(a[i], b[i]))
        torch.testing.assert_close(ops.tri2full(s)[i], ops.tri2full(s[i]))
    assert ops.launch_counts() == before


# ------------------------------------------------ launch rules at batch 1 --

SHAPES3 = list(itertools.product(SWEEP_DIMS, repeat=3))


@pytest.mark.parametrize("m,k,n", SHAPES3)
def test_launch_rules_at_batch_one_pick_what_they_picked(m, k, n):
    sms = kgemm.SMS
    assert kgemm.gemm_config(m, n, k, sms, 1) == kgemm.gemm_config(m, n, k)
    for c in kgemm.candidates(k):
        assert kgemm.gemm_cost(m, n, c, sms, 1) == kgemm.gemm_cost(m, n, c)
    assert ksymm.symm_config(m, n, sms, 1) == ksymm.symm_config(m, n) == \
        kgemm.gemm_config(m, n, m)
    assert ksyrk.syrk_config(m, k, sms, 1) == ksyrk.syrk_config(m, k)
    for c in ksyrk.syrk_candidates(k):
        assert ksyrk.syrk_cost(m, c, sms, 1) == ksyrk.syrk_cost(m, c)
    for l in SWEEP_DIMS:
        assert kchain.chain_config(m, k, l, n, sms, 1) == \
            kchain.chain_config(m, k, l, n)
        for c in kchain.CONFIGS:
            assert kchain.chain_cost(m, k, l, n, c, sms, 1) == \
                kchain.chain_cost(m, k, l, n, c)
    # abab's pair: (m, k, l) = (m, k, n).
    active = kfused.ACTIVE_CLUSTERS
    assert kfused.gemm_syrk_config(m, k, n, active, 1) == \
        kfused.gemm_syrk_config(m, k, n)
    for c in kfused.candidates(m):
        assert kfused.gemm_syrk_cost(m, k, n, c, active, 1) == \
            kfused.gemm_syrk_cost(m, k, n, c)


@pytest.mark.parametrize("batch", [2, 32, 256])
def test_launch_rules_at_a_batch_are_the_least_modeled_cost(batch):
    """A batch multiplies each launch's blocks: the pick is the candidate
    of least cost over all the batch's blocks (a split rarely pays)."""
    sms = kgemm.SMS
    for m, k, n in SHAPES3[::4]:
        cfg = kgemm.gemm_config(m, n, k, sms, batch)
        best = min(kgemm.gemm_cost(m, n, c, sms, batch)
                   for c in kgemm.candidates(k))
        assert kgemm.gemm_cost(m, n, cfg, sms, batch) == best
        cfg = kfused.gemm_syrk_config(m, k, n, kfused.ACTIVE_CLUSTERS, batch)
        best = min(kfused.gemm_syrk_cost(m, k, n, c, kfused.ACTIVE_CLUSTERS,
                                         batch) for c in kfused.candidates(m))
        assert kfused.gemm_syrk_cost(m, k, n, cfg, kfused.ACTIVE_CLUSTERS,
                                     batch) == best


# --------------------------------------------- schedule twins at a batch --

@pytest.mark.parametrize("m,k,n", [(130, 70, 200), (64, 400, 64), (5, 33, 3)])
def test_gemm_and_symm_twins_cover_each_instance_tile_and_slice_once(m, k, n):
    for cfg in kgemm.candidates(k) + kgemm.candidates(m):
        kk = k if cfg in kgemm.candidates(k) else m   # symm contracts over m
        cover = np.zeros((BATCH, m, n), dtype=np.int64)
        seen = {}
        for inst, row0, col0, k0, k1 in kgemm.gemm_batch_blocks(
                m, n, kk, cfg, BATCH):
            cover[inst, row0:row0 + cfg.bm, col0:col0 + cfg.bn] += 1
            key = (inst, row0, col0, k0)
            assert key not in seen   # each (instance, tile, slice) once
            seen[key] = k1
        assert (cover == cfg.split).all()
        assert len(seen) == BATCH * cfg.blocks(m, n)
        assert list(kgemm.gemm_blocks(m, n, kk, cfg)) == [
            b[1:] for b in kgemm.gemm_batch_blocks(m, n, kk, cfg, 1)]


@pytest.mark.parametrize("m,k", [(130, 70), (400, 800), (65, 17)])
def test_syrk_twin_covers_each_instance_tile_and_slice_once(m, k):
    for cfg in ksyrk.syrk_candidates(k):
        cover = np.zeros((BATCH, m, m), dtype=np.int64)
        keys = set()
        for inst, row0, col0, k0, _ in ksyrk.syrk_batch_blocks(
                m, k, cfg, BATCH):
            assert col0 <= row0
            cover[inst, row0:row0 + cfg.bm, col0:col0 + cfg.bm] += 1
            keys.add((inst, row0, col0, k0))
        low = np.tril(np.ones((m, m), dtype=bool))
        assert (cover[:, low] == cfg.split).all()
        assert len(keys) == BATCH * ksyrk.tiles(m, cfg.bm) * cfg.split


@pytest.mark.parametrize("m,l", [(130, 150), (65, 200), (5, 1)])
def test_chain_twin_builds_each_instances_m1_once(m, l):
    for cfg in kchain.CONFIGS:
        cover = np.zeros((BATCH, m, l), dtype=np.int64)
        n = 0
        for inst, row0, l0, l1 in kchain.chain_batch_blocks(m, l, cfg, BATCH):
            cover[inst, row0:row0 + cfg.bm, l0:l1] += 1
            n += 1
        assert (cover == 1).all() and n == BATCH * cfg.blocks(m, l)


@pytest.mark.parametrize("m,k,l", [(130, 20, 40), (200, 8, 100)])
def test_gemm_syrk_twin_covers_each_instances_pairs_once(m, k, l):
    for cfg in kfused.candidates(m)[::5]:
        mt = -(-m // kfused.BM)
        pairs = np.zeros((BATCH, cfg.chunks(l), mt, mt), dtype=np.int64)
        pieces = np.zeros((BATCH, cfg.chunks(l), mt), dtype=np.int64)
        for inst, chunk, _, built, tiles in kfused.gemm_syrk_batch_blocks(
                m, k, l, cfg, BATCH):
            for i in built:
                pieces[inst, chunk, i] += 1
            for i, j in tiles:
                pairs[inst, chunk, i, j] += 1
        assert (pieces == 1).all()
        assert (pairs == np.tril(np.ones((mt, mt), dtype=np.int64))).all()


def test_grids_stay_within_the_cards_limit_at_batch_70000():
    batch = 70_000
    limit = kgemm.MAX_GRID_YZ
    assert limit == 65_535
    gemm_cfg = kgemm.with_split(2, 32, 2)   # one 64x64 tile, two slices
    gx, gy, gz = kgemm.gemm_grid(8, 8, gemm_cfg, batch)
    assert (gx, gy) == (1, 1) and gz == limit
    units = [(b[0], b[3]) for b in kgemm.gemm_batch_blocks(
        8, 8, 32, gemm_cfg, batch)]
    assert len(units) == len(set(units)) == batch * 2
    syrk_cfg = kgemm.with_split(2, 32, 1)
    assert ksyrk.syrk_grid(8, syrk_cfg, batch) == (1, limit)
    insts = [b[0] for b in ksyrk.syrk_batch_blocks(8, 32, syrk_cfg, batch)]
    assert sorted(insts) == list(range(batch))
    chain_cfg = kchain.CONFIGS[2]
    assert kchain.chain_grid(8, 8, chain_cfg, batch) == (1, 1, limit)
    insts = [b[0] for b in kchain.chain_batch_blocks(8, 8, chain_cfg, batch)]
    assert sorted(insts) == list(range(batch))
    fused_cfg = kfused.GemmSyrkConfig(16, 1)
    assert kfused.gemm_syrk_grid(8, fused_cfg, batch) == (1, limit)
    insts = [c[0] for c in kfused.gemm_syrk_batch_blocks(8, 8, 8, fused_cfg,
                                                          batch)]
    assert sorted(insts) == list(range(batch))
