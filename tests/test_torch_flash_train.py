"""Training's attention kernels (``kernels/flash_train.py``) on the CPU:
the route ``chunked_attention`` takes, the operands the wrapper refuses,
and a schedule twin of the kernels' tile walk against a brute-force
visibility mask. The kernels themselves run on the card
(``tests/test_torch_gpu.py -k flash_train``)."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_train, ops
from repro_torch.models import attention
from repro_torch.runtime.spans import Recorder


def _qkv(b, s, h, hkv, d, dtype=torch.bfloat16, seed=0):
    gen = torch.Generator().manual_seed(seed)
    return [torch.randn((b, s, n, d), generator=gen).to(dtype)
            for n in (h, hkv, hkv)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_on_the_cpu_chunked_attention_takes_the_plain_core(dtype):
    """On the CPU every call takes ``_ChunkedCore`` (also bf16 at a head
    dim and shape the kernels take), counts ``attention.train.plain`` and
    launches nothing; forward and backward are the plain core's bits."""
    cfg = attention.AttnConfig(d_model=256, n_heads=4, n_kv_heads=2,
                               head_dim=64, window=300)
    q, k, v = _qkv(1, 512, 4, 2, 64, dtype)
    g = torch.randn(q.shape, generator=torch.Generator().manual_seed(1)
                    ).to(dtype)
    assert not flash_train.takes(q, k, v, cfg.window)
    runs = []
    ops.reset_launch_counts()
    for fn in (attention.chunked_attention, attention.chunked_plain):
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        with Recorder("cpu") as rec:
            out = fn(cfg, *leaves, block=256)
        out.backward(g)
        runs.append((dict(rec.counts), [out.detach()] +
                     [t.grad for t in leaves]))
    assert runs[0][0] == {"attention.train.plain": 1}
    assert runs[1][0] == {}
    assert not any(ops.launch_counts().values())
    for got, want in zip(runs[0][1], runs[1][1]):
        assert torch.equal(got, want)


def test_the_wrapper_runs_on_the_card_only():
    q, k, v = _qkv(1, 128, 2, 2, 64)
    with pytest.raises(ValueError, match="CUDA tensors only"):
        flash_train.attention(q, k, v, scale=0.125)


def _bad(name):
    """Operands the kernels lack, one fault each: (q, k, v, window)."""
    q, k, v = _qkv(1, 256, 4, 2, 64)
    if name == "dtype":
        return q.float(), k.float(), v.float(), 0
    if name == "head_dim":
        return *_qkv(1, 256, 4, 2, 96), 0
    if name == "seq":
        return *_qkv(1, 200, 4, 2, 64), 0
    if name == "heads":
        return *_qkv(1, 256, 4, 3, 64), 0
    if name == "kv_head_dim":
        return q, k[..., :32], v, 0
    if name == "seq_mismatch":
        return q, k[:, :128], v[:, :128], 0
    if name == "rank":
        return q[0], k[0], v[0], 0
    return q, k, v, -1


@pytest.mark.parametrize("name,match", [
    ("dtype", "bfloat16"), ("head_dim", "head_dim D=96"), ("seq", "S=200"),
    ("heads", "Hkv=3"), ("kv_head_dim", "head_dim D mismatch"),
    ("seq_mismatch", "sequence dim S mismatch"), ("rank", r"\(B, S, H, D\)"),
    ("window", "window=-1")])
def test_check_refuses_what_the_kernels_lack(name, match):
    q, k, v, window = _bad(name)
    with pytest.raises(ValueError, match=match):
        flash_train.check(q, k, v, window)
    assert not flash_train.takes(q, k, v, max(window, 0))


def test_check_admits_the_cells_shape():
    flash_train.check(*_qkv(1, 2048, 32, 32, 128, torch.bfloat16))
    flash_train.check(*_qkv(2, 384, 4, 1, 64, torch.bfloat16), window=300)


def _visible(seq, causal, window):
    qpos = np.arange(seq)[:, None]
    kpos = np.arange(seq)[None, :]
    mask = np.ones((seq, seq), dtype=bool)
    if causal:
        mask &= qpos >= kpos
    if window > 0:
        mask &= qpos - kpos < window
    return mask


@pytest.mark.parametrize("seq,heads,kv_heads,d,causal,window", [
    (512, 4, 4, 128, True, 0), (512, 4, 2, 64, True, 0),
    (512, 4, 2, 64, True, 300), (640, 8, 1, 128, True, 300),
    (512, 4, 4, 64, True, 1), (512, 4, 2, 128, True, 100),
    (512, 4, 2, 64, False, 0), (512, 4, 2, 128, False, 200),
    (384, 2, 1, 64, True, 1000), (2048, 2, 2, 128, True, 0)])
def test_the_schedule_visits_each_visible_tile_pair_once(seq, heads, kv_heads,
                                                         d, causal, window):
    """Each kernel's walk (``flash_train.schedule``, the source's
    ``key_tiles`` / ``query_tiles``) visits exactly the tile pairs in
    which some query sees some key, once each, every query head under its
    kv head h // (H / Hkv); every visible pair lies in a visited tile
    pair."""
    mask = _visible(seq, causal, window)
    group = heads // kv_heads
    walks = flash_train.schedule(seq, heads, kv_heads, d, causal, window)
    for name, (rows, step) in flash_train.TILES[d].items():
        visits = walks[name]
        assert len(visits) == len(set(visits)), name
        bq, bk = (step, rows) if name == "dkdv" else (rows, step)
        want = {(h, h // group, (q0, q0 + bq), (k0, k0 + bk))
                for h in range(heads)
                for q0 in range(0, seq, bq) for k0 in range(0, seq, bk)
                if mask[q0:q0 + bq, k0:k0 + bk].any()}
        assert set(visits) == want, name
        covered = np.zeros_like(mask)
        for h, _, (q0, q1), (k0, k1) in visits:
            covered[q0:q1, k0:k1] |= h == 0
        assert not (mask & ~covered).any(), name
