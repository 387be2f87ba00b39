"""The port's serving path against the JAX package's, on the CPU.

Decode steps, the training forward and ``generate`` of the dense smoke
configs, with the reference's weights carried into the port by
``repro_torch.models.convert`` and the same seeded numpy tokens into
both. Float32 logits compare at rtol = atol = 1e-4, as in
tests/test_kernels.py; bfloat16 KV caches at rtol = 2**-7 (one ulp),
atol = 1e-5, as in tests/test_torch_models.py. Greedy generation must be
token-identical (both under ``REPRO_SERVE_PLANNER=0``, as before the plan
cache was ported; the consult picks the left association there anyway).

The serving plan cache (``repro_torch.serve.plan_cache``), the
``BackgroundWorker`` and the load test are held to the counterparts of
tests/test_serve.py: concurrency, coalescing, the first-lookup deadlock,
invalidation, drop-oldest, the drain, the decode consult and its
kill-switch, ``plan_warmup`` and the load-test gate, on the CPU.
"""

import collections
import dataclasses
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_smoke as jget_smoke
from repro.core.planner import Planner as JPlanner
from repro.models import api as japi
from repro.runtime.supervisor import BackgroundWorker as JWorker
from repro.runtime.supervisor import StragglerMonitor as JStragglerMonitor
from repro.serve.decode import generate as jgenerate
from repro.serve.plan_cache import PlanService as JPlanService
from repro_torch import configs
from repro_torch.core.expressions import get_spec
from repro_torch.core.perfmodel import TableProfile
from repro_torch.core.planner import Planner
from repro_torch.models import api, attention, convert, transformer
from repro_torch.runtime import BackgroundWorker, StragglerMonitor
from repro_torch.serve import decode, loadtest, plan_cache
from repro_torch.serve.plan_cache import (
    PlanCache, PlanService, RefinementQueue, default_plan_service,
    planner_enabled, reset_default_plan_service)

TOL = dict(rtol=1e-4, atol=1e-4)
CACHE_TOL = dict(rtol=2 ** -7, atol=1e-5)


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32))


def _tokens(cfg, b, s, seed):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s),
                                                dtype=np.int32)


@pytest.fixture(scope="module")
def smoke_models():
    """arch → (reference cfg, reference params, port cfg, port model)."""
    out = {}
    for arch in ("yi_9b", "gemma2_9b"):
        jcfg = jget_smoke(arch)
        params, _ = japi.init(jax.random.PRNGKey(0), jcfg)
        cfg = configs.get_smoke(arch)
        model = convert.from_reference_params(
            jax.tree.map(np.asarray, params), cfg, device="cpu")
        out[arch] = (jcfg, params, cfg, model)
    return out


def _port_caches(jc):
    """The reference's caches as the port's (bfloat16 values unchanged)."""
    def t(a):
        return torch.tensor(_np(a)).to(torch.bfloat16)
    return transformer.LayerCaches(kv=attention.KVCache(
        t(jc.kv.k), t(jc.kv.v), torch.tensor(int(jc.kv.length[0]))))


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_decode_from_the_same_cache_matches_reference(smoke_models, arch):
    """Window 32 of gemma2's local layers bites at position 40."""
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 40, 8)
    _, jc = japi.prefill(params, jcfg, {"tokens": jnp.asarray(toks)},
                         japi.init_caches(params, jcfg, 2, 48))
    caches = _port_caches(jc)
    for step in range(2):
        nt = _tokens(cfg, 2, 1, 9 + step)
        want, jc = japi.decode_step(params, jcfg, jnp.asarray(nt), jc)
        got, caches = api.decode_step(model, cfg, nt, caches)
        assert got.shape == (2, 1, cfg.vocab)
        np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
        assert int(caches.kv.length) == int(jc.kv.length[0]) == 41 + step
        np.testing.assert_allclose(caches.kv.k.float().numpy(),
                                   _np(jc.kv.k), **CACHE_TOL)


@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_forward_train_matches_reference(smoke_models, arch):
    jcfg, params, cfg, model = smoke_models[arch]
    toks = _tokens(cfg, 2, 64, 10)
    want, jaux = japi.forward_train(params, jcfg, {"tokens": toks})
    got, aux = api.forward_train(model, cfg, {"tokens": toks})
    np.testing.assert_allclose(got.numpy(), _np(want), **TOL)
    assert float(aux) == float(jaux) == 0.0


@pytest.mark.parametrize("arch", ["glm4_9b", "gemma2_9b", "phi3_mini"])
def test_decode_matches_teacher_forced_forward(arch):
    """Port-only counterpart of tests/test_models.py: token-by-token
    decode equals the full forward up to bf16 cache storage (2e-2)."""
    cfg = configs.get_smoke(arch)
    model = api.init(cfg, seed=0, device="cpu")
    toks = _tokens(cfg, 1, 8, 3)
    full, _ = api.forward_train(model, cfg, {"tokens": toks})
    caches = api.init_caches(model, cfg, 1, 32)
    outs = []
    for i in range(8):
        step, caches = api.decode_step(model, cfg, toks[:, i:i + 1], caches)
        outs.append(step[:, 0])
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(), full.numpy(),
                               rtol=2e-2, atol=2e-2)


def test_padded_vocab_columns_are_masked():
    cfg = dataclasses.replace(configs.get_smoke("phi3_mini"), vocab=250)
    assert cfg.padded_vocab == 256
    model = api.init(cfg, seed=0, device="cpu")
    logits, _ = api.forward_train(model, cfg, {"tokens": [[1, 2, 3]]})
    assert logits.shape == (1, 3, 256)
    assert bool((logits[..., 250:] == -1e30).all())
    assert bool((logits[..., :250] > -1e29).all())



@pytest.mark.parametrize("arch", ["yi_9b", "gemma2_9b"])
def test_generate_is_token_identical_to_reference(smoke_models, monkeypatch,
                                                  arch):
    """Window 32 of gemma2's local layers bites past position 32."""
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    jcfg, params, cfg, model = smoke_models[arch]
    prompt = _tokens(cfg, 2, 30, 11)
    want = np.asarray(jgenerate(params, jcfg, jnp.asarray(prompt),
                                max_new=8, max_s=40))
    got = decode.generate(model, cfg, prompt, max_new=8, max_s=40)
    assert got.shape == (2, 38) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_greedy_consistency(smoke_models):
    """Port-only counterpart of tests/test_distribution.py: re-scoring the
    generated sequence predicts its last token greedily."""
    _, _, cfg, model = smoke_models["yi_9b"]
    out = decode.generate(model, cfg, [[5, 9, 2]], max_new=4, max_s=16)
    assert out.shape == (1, 7)
    logits, _ = api.forward_train(model, cfg, {"tokens": out[:, :-1]})
    assert int(torch.argmax(logits[0, -1])) == int(out[0, -1])


def test_sampling_draws_from_the_seeded_generator(smoke_models):
    _, _, cfg, model = smoke_models["gemma2_9b"]
    prompt = _tokens(cfg, 2, 4, 12)
    runs = [decode.generate(model, cfg, prompt, max_new=6, temperature=1.0,
                            seed=seed) for seed in (7, 7, 8)]
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab


def test_serve_step_and_monitor(smoke_models):
    _, _, cfg, model = smoke_models["yi_9b"]
    caches = api.init_caches(model, cfg, 2, 8)
    state = decode.ServeState(caches, torch.tensor([[1], [2]]),
                              torch.Generator().manual_seed(0))
    step = decode.make_serve_step(cfg)
    state, nxt = step(state, model)
    assert nxt.shape == (2, 1) and int(state.caches.kv.length) == 1
    assert torch.equal(state.last_tokens, nxt)
    assert decode.plan_warmup(cfg, 8, device="cpu") == [
        ("decattn", (1, 8, cfg.head_dim, cfg.d_model)),
        ("decproj", (1, cfg.d_model, cfg.n_heads * cfg.head_dim)),
        ("decmlp", (1, cfg.d_model, cfg.d_ff)),
        ("decproj", (1, cfg.d_model, cfg.vocab))]
    monitor = StragglerMonitor()
    decode.generate(model, cfg, [[1, 2]], max_new=3, monitor=monitor)
    assert monitor.n == 3


def test_straggler_monitor_matches_reference():
    times = [1.0, 1.1, 0.9, 1.0, 1.0, 1.05, 5.0, 1.0, 3.0, 0.95]
    mine, theirs = StragglerMonitor(warmup_steps=3), \
        JStragglerMonitor(warmup_steps=3)
    flags = [mine.observe(i, t) for i, t in enumerate(times)]
    assert flags == [theirs.observe(i, t) for i, t in enumerate(times)]
    assert mine.flagged == theirs.flagged == [6, 8]
    assert mine.ema == pytest.approx(theirs.ema)


def test_decode_past_the_cache_raises(smoke_models):
    """A step cannot read its position on the host (it may be a CUDA
    graph's replay), so ``generate`` checks the count before the first
    step: a prompt of 2 and 2 new tokens write 3 positions, which 3 hold
    and 2 do not."""
    _, _, cfg, model = smoke_models["yi_9b"]
    assert decode.generate(model, cfg, [[1, 2]], max_new=2,
                           max_s=3).shape == (1, 4)
    with pytest.raises(ValueError, match="KV cache full"):
        decode.generate(model, cfg, [[1, 2]], max_new=2, max_s=2)


# ------------------------------------------------ the serving plan cache --

@pytest.fixture
def fresh_services(monkeypatch, tmp_path):
    monkeypatch.setenv("REPRO_PROFILE_DIR", str(tmp_path))
    monkeypatch.delenv("REPRO_SERVE_PLANNER", raising=False)
    reset_default_plan_service()
    yield
    reset_default_plan_service()


def _service(**kw):
    return PlanService(discriminant=kw.pop("discriminant", "flops"),
                       device="cpu", **kw)


def _table_planner() -> Planner:
    return Planner(discriminant="perfmodel", backend="torch", device="cpu",
                   profile=TableProfile(peak_flops=1e12))


def _seed_decmlp(planner, dims, fast_idx):
    """Record call times making algorithm ``fast_idx`` the cheapest."""
    algs = get_spec("decmlp").algorithms(dims)
    for i, alg in enumerate(algs):
        for call in alg.calls:
            planner.profile.record(call, 1e-6 if i == fast_idx else 1e-3)
    return algs


def test_stress_no_torn_reads_and_single_enumeration(fresh_services):
    svc = _service()
    calls, lock = [], threading.Lock()
    inner = svc.planner.plan

    def slow_plan(chain, env=None):
        with lock:
            calls.append(chain)
        time.sleep(0.02)            # widen the race window
        return inner(chain, env)

    svc.planner.plan = slow_plan
    threads, per_thread = 16, 20
    shapes = [("decmlp", (1, 64, 256)), ("decproj", (1, 64, 128)),
              ("decattn", (1, 128, 32, 64))]
    start = threading.Barrier(threads)
    results = [[] for _ in range(threads)]
    errors = []

    def worker(tid):
        try:
            start.wait()
            for i in range(per_thread):
                fam, dims = shapes[(tid + i) % len(shapes)]
                results[tid].append((fam, svc.lookup(fam, dims)))
        except BaseException as e:   # noqa: BLE001
            errors.append(e)

    ts = [threading.Thread(target=worker, args=(i,)) for i in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errors
    assert len(calls) == len(shapes)         # one enumeration per shape
    by_family = {}
    for chunk in results:
        for fam, plan in chunk:
            assert plan is by_family.setdefault(fam, plan)
    stats = svc.cache.stats()
    assert stats["misses"] == len(shapes)
    assert stats["hits"] + stats["coalesced"] == \
        threads * per_thread - len(shapes)


def test_coalesced_waiters_share_one_plan(fresh_services):
    svc = _service()
    inner = svc.planner.plan
    svc.planner.plan = lambda c, env=None: (time.sleep(0.05),
                                            inner(c, env))[1]
    n, seen, lock = 12, [], threading.Lock()
    start = threading.Barrier(n)

    def worker():
        start.wait()
        p = svc.lookup("decmlp", (2, 96, 384))
        with lock:
            seen.append(p)

    ts = [threading.Thread(target=worker) for _ in range(n)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert len({id(p) for p in seen}) == 1
    stats = svc.cache.stats()
    assert (stats["misses"], stats["coalesced"]) == (1, n - 1)


def test_first_lookup_double_check_hit_does_not_deadlock():
    """Regression test of the reference's first-lookup deadlock: a
    thread's first lookup whose lock-free probe misses but whose
    double-check under the lock hits must not register its stat slot
    under the held lock."""
    cache = PlanCache()
    plan, key = object(), ("k", 0)

    class RacingDict(dict):
        probes = 0

        def get(self, k, default=None):
            self.probes += 1
            if self.probes == 1:
                return None          # the lock-free probe misses
            return super().get(k, default)

    racing = RacingDict()
    racing[key] = plan
    cache._plans = racing
    result = []
    t = threading.Thread(target=lambda: result.append(
        cache.get(key, lambda: pytest.fail("must not compute"))),
        daemon=True)
    t.start()
    t.join(timeout=5.0)
    assert not t.is_alive(), "first-lookup double-check hit deadlocked"
    assert result == [plan] and cache.stats()["hits"] == 1


def test_miss_error_propagates_and_shape_retries():
    cache, boom = PlanCache(), [True]

    def compute():
        if boom[0]:
            raise RuntimeError("enumeration failed")
        return "plan"

    with pytest.raises(RuntimeError):
        cache.get(("k", 0), compute)
    boom[0] = False
    assert cache.get(("k", 0), compute) == "plan"
    assert cache.stats()["errors"] == 1


def test_generation_bump_flips_stale_plan(fresh_services):
    planner = _table_planner()
    dims = (4, 64, 256)
    algs = _seed_decmlp(planner, dims, fast_idx=0)
    svc = PlanService(planner=planner)
    assert svc.lookup("decmlp", dims).algorithm.name == algs[0].name
    gen0 = planner.profile_generation()
    _seed_decmlp(planner, dims, fast_idx=1)
    assert planner.profile_generation() > gen0
    assert svc.lookup("decmlp", dims).algorithm.name == algs[1].name
    assert svc.cache.stats()["size"] == 1        # the stale entry purged


def test_cache_key_components(fresh_services):
    svc = PlanService(discriminant="flops", backend="torch", dtype="bf16",
                      device="cpu")
    key = svc.key("decproj", (1, 8, 8))
    assert key[:4] == ("decproj", (1, 8, 8), "bf16", "torch")
    assert key[4] == svc.planner.policy_fingerprint()
    assert key[5] == svc.planner.profile_generation()
    # The same components as the reference's key.
    ref = JPlanService(discriminant="flops", backend="numpy", dtype="bf16")
    ref_key = ref.key("decproj", (1, 8, 8))
    assert (key[0], key[1], key[2], key[4], key[5]) == \
        (ref_key[0], ref_key[1], ref_key[2], ref_key[4], ref_key[5])


def test_refinement_queue_drops_oldest_without_blocking():
    q = RefinementQueue(maxlen=4)
    for i in range(10):
        q.put(i)
    assert (q.enqueued, q.dropped, len(q)) == (10, 6, 4)
    assert [q.pop() for _ in range(4)] == [6, 7, 8, 9]
    assert q.pop() is None


def test_execute_refines_asynchronously_and_shutdown_drains(fresh_services):
    planner = _table_planner()
    dims = (4, 64, 256)
    _seed_decmlp(planner, dims, fast_idx=0)
    svc = PlanService(planner=planner, refine=True, queue_maxlen=256)
    gen0 = planner.profile.generation
    x, wu, wd = torch.ones(4, 64), torch.ones(64, 256), torch.ones(256, 64)
    n = 32
    for _ in range(n):
        out = svc.execute("decmlp", dims, x, wu, wd)
    torch.testing.assert_close(out, (x @ wu) @ wd)
    assert svc.queue.enqueued == n
    assert svc.shutdown(drain=True)
    assert len(svc.queue) == 0 and svc.worker.steps >= n
    assert planner.profile.generation > gen0
    svc.execute("decmlp", dims, x, wu, wd)      # runs, no longer enqueues
    assert svc.queue.enqueued == n


def test_shutdown_folds_straggler_timing_enqueued_during_race(
        fresh_services):
    planner = _table_planner()
    dims = (4, 64, 256)
    _seed_decmlp(planner, dims, fast_idx=0)
    svc = PlanService(planner=planner, refine=True)
    plan = svc.lookup("decmlp", dims)
    assert svc.worker.stop(drain=True)          # worker gone, queue empty
    gen0 = planner.profile.generation
    svc.queue.put((plan, 1e-4))                 # the racing straggler
    assert svc.shutdown(drain=True)
    assert len(svc.queue) == 0 and planner.profile.generation > gen0


@pytest.mark.parametrize("cls", [BackgroundWorker, JWorker])
def test_background_worker_drain_is_deterministic(cls):
    items, done = collections.deque(range(100)), []

    def step():
        if not items:
            return False
        done.append(items.popleft())
        return True

    w = cls(step, idle_wait_s=0.01).start()
    assert w.stop(drain=True)
    assert done == list(range(100)) and not w.running


@pytest.mark.parametrize("cls", [BackgroundWorker, JWorker])
def test_background_worker_poisoned_step_does_not_wedge_drain(cls):
    items, caught = collections.deque(range(10)), []

    def step():
        if not items:
            return False
        v = items.popleft()
        if v % 3 == 0:
            raise ValueError(v)
        return True

    w = cls(step, on_error=caught.append, idle_wait_s=0.01).start()
    assert w.stop(drain=True)
    assert not items and w.errors == len(caught) == 4   # 0, 3, 6, 9
    assert w.steps == 10


def test_background_worker_prompt_stop_leaves_items():
    """``stop(drain=False)`` exits before the next step: what the owner
    queued stays queued."""
    gate, items = threading.Event(), collections.deque(range(5))

    def step():
        gate.wait(5.0)
        if not items:
            return False
        items.popleft()
        return True

    w = BackgroundWorker(step, idle_wait_s=0.01).start()
    stopper = threading.Thread(target=w.stop, kwargs={"drain": False})
    stopper.start()
    time.sleep(0.05)           # the worker is parked inside its first step
    gate.set()
    stopper.join(timeout=5.0)
    assert not stopper.is_alive() and not w.running
    assert len(items) == 4 and w.steps == 1


@pytest.mark.parametrize("hkv", [4, 2, 1])
def test_pv_wo_output_orders_agree(hkv, monkeypatch):
    """Left and right association give the same output, with GQA (kv
    head ``h // group``) and against the reference's head-expanded
    right-first order."""
    from repro.models import attention as jattention
    from repro_torch.models.layers import Dense

    rng = np.random.default_rng(hkv)
    b, h, s, dh, d = 2, 4, 16, 8, 32
    p = rng.standard_normal((b, h, 1, s)).astype(np.float32)
    v = rng.standard_normal((b, s, hkv, dh)).astype(np.float32)
    w = rng.standard_normal((h * dh, d)).astype(np.float32)
    wo = Dense(h * dh, d, generator=torch.Generator().manual_seed(0),
               device="cpu", dtype=torch.float32)
    with torch.no_grad():
        wo.w.copy_(torch.from_numpy(w))
    pt, vt = torch.from_numpy(p), torch.from_numpy(v)

    def no_consult(*a, **k):
        raise AssertionError("pv_wo_output consulted the planner")

    # The order comes from the cache's resolved flag: no per-call consult.
    monkeypatch.setattr(attention, "planned_pv_right_first", no_consult)
    left, right = (attention.pv_wo_output(pt, vt, wo, h, dh, torch.float32,
                                          right_first=r)
                   for r in (False, True))
    assert left.shape == right.shape == (b, 1, d)
    np.testing.assert_allclose(left.numpy(), right.numpy(), rtol=2e-4,
                               atol=2e-4)
    vq = np.repeat(v, h // hkv, axis=2)
    monkeypatch.setattr(jattention, "planned_pv_right_first",
                        lambda *a: True)
    want = jattention.pv_wo_output(jnp.asarray(p), jnp.asarray(vq),
                                   {"w": jnp.asarray(w)}, h, dh, jnp.float32)
    np.testing.assert_allclose(right.numpy(), _np(want), rtol=2e-4,
                               atol=2e-4)


def test_planner_consult_picks_left_at_decode(fresh_services, monkeypatch):
    """Counterpart of the reference's test: at t = 1 left is cheaper
    under any cost model; the port's default policy (perfmodel, the
    Hopper model) and flops both pick it, as the reference does."""
    from repro.models import attention as jattention
    from repro.serve.plan_cache import reset_default_plan_service as jreset
    for disc in ("perfmodel", "flops"):
        monkeypatch.setenv("REPRO_SERVE_DISCRIMINANT", disc)
        reset_default_plan_service()
        assert attention.planned_pv_right_first(
            1, 512, 64, 256, device="cpu") is False
        svc = default_plan_service("cpu")
        assert svc.planner.discriminant == disc
        assert svc.cache.stats()["misses"] == 1
    monkeypatch.setenv("REPRO_SERVE_DISCRIMINANT", "flops")
    jreset()
    assert jattention.planned_pv_right_first(1, 512, 64, 256) is False
    jreset()
    # Without a card the cuda service cannot be built: still left, and
    # the failure is reported, not swallowed.
    if not torch.cuda.is_available():
        with pytest.warns(RuntimeWarning, match="consult failed"):
            assert attention.planned_pv_right_first(1, 512, 64, 256) is False


def test_decode_consults_with_the_cache_capacity(fresh_services,
                                                 smoke_models, monkeypatch):
    """The decode tail consults ``decattn`` once per KV cache, at its
    capacity: a served decode after ``plan_warmup`` misses only the
    warmed shapes and hits once, however many layers and tokens; the
    steps read the cache's flag, and a flag of right gives the same
    logits as left."""
    _, _, cfg, model = smoke_models["yi_9b"]
    asked = []
    consult = attention.planned_pv_right_first
    monkeypatch.setattr(attention, "planned_pv_right_first",
                        lambda *a, **k: asked.append(a) or consult(*a, **k))
    out = decode.generate(model, cfg, [[5, 9, 2]], max_new=4, max_s=12)
    stats = default_plan_service("cpu").cache.stats()
    assert stats["misses"] == 4 and stats["hits"] == 1
    assert asked == [(1, 12, cfg.head_dim, cfg.d_model)]
    assert out.shape == (1, 7)
    caches = api.init_caches(model, cfg, 1, 12)
    assert caches.kv.right_first is False and len(asked) == 2
    right = transformer.LayerCaches(kv=caches.kv._replace(
        right_first=True, k=caches.kv.k.clone(), v=caches.kv.v.clone(),
        length=caches.kv.length.clone()))
    tok = torch.tensor([[5]])
    got_left, left = api.decode_step(model, cfg, tok, caches)
    got_right, right = api.decode_step(model, cfg, tok, right)
    assert len(asked) == 2 and right.kv.right_first is True
    np.testing.assert_allclose(got_right.float().numpy(),
                               got_left.float().numpy(), rtol=1e-4,
                               atol=1e-4)


def test_planner_kill_switch(fresh_services, monkeypatch, smoke_models):
    monkeypatch.setenv("REPRO_SERVE_PLANNER", "0")
    assert planner_enabled() is False
    assert attention.planned_pv_right_first(1, 512, 64, 256,
                                            device="cpu") is False
    _, _, cfg, model = smoke_models["yi_9b"]
    assert decode.plan_warmup(cfg, 64, device="cpu") == []
    out = decode.generate(model, cfg, [[5, 9, 2]], max_new=2)
    assert out.shape == (1, 5)
    assert default_plan_service("cpu").cache.stats()["lookups"] == 0


def test_plan_warmup_populates_the_default_service_as_the_reference(
        fresh_services, monkeypatch):
    from repro.models.transformer import ModelConfig as JModelConfig
    from repro.serve import decode as jdecode
    from repro.serve.plan_cache import reset_default_plan_service as jreset
    monkeypatch.setenv("REPRO_SERVE_DISCRIMINANT", "flops")
    cfg = configs.get_smoke("yi_9b")
    jcfg = JModelConfig(name="t", family="dense", n_layers=cfg.n_layers,
                        d_model=cfg.d_model, vocab=cfg.vocab,
                        n_heads=cfg.n_heads, n_kv_heads=cfg.n_kv_heads,
                        head_dim=cfg.head_dim, d_ff=cfg.d_ff)
    jreset()
    want = jdecode.plan_warmup(jcfg, max_s=64)
    jreset()
    shapes = decode.plan_warmup(cfg, max_s=64, device="cpu")
    assert shapes == want
    svc = default_plan_service("cpu")
    assert svc.cache.stats()["size"] == len(set(shapes))
    svc.lookup("decattn", (1, 64, cfg.head_dim, cfg.d_model))
    assert svc.cache.stats()["hits"] == 1


def test_default_services_are_one_per_device(fresh_services, monkeypatch):
    a = default_plan_service("cpu")
    assert default_plan_service(torch.device("cpu")) is a
    assert a.planner.backend == "cuda" and a.planner.device == "cpu"
    reset_default_plan_service()
    assert default_plan_service("cpu") is not a
    # Cards are told apart by index: a plan of cuda:1's service runs on
    # cuda:1, not on the current card; ``cuda`` is the current card, so
    # warm-up by name and a consult by a tensor's device share a service
    # (services and the card stubbed: no card here).
    built = []
    monkeypatch.setattr(plan_cache, "PlanService",
                        lambda **kw: built.append(kw["device"]) or kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    for dev in ("cuda:1", torch.device("cuda", 1), "cuda", "cuda:0",
                torch.device("cuda")):
        default_plan_service(dev)
    assert built == ["cuda:1", "cuda:0"]
    reset_default_plan_service(shutdown=False)


def test_loadtest_harness_reports_sane_numbers(fresh_services):
    def make_service():
        return _service()

    rep = loadtest.run_loadtest(make_service(), requests=400, threads=4,
                                make_service=make_service)
    assert rep.requests == 400 and rep.hit_rate > 0.99
    assert 0 < rep.hit_p50_us <= rep.hit_p99_us
    assert rep.miss_p50_us > 0
    assert rep.burst_misses == 1 and rep.coalesce_effectiveness == 1.0
    assert rep.stats["errors"] == 0
    # Without a factory the burst builds a like service itself.
    rep = loadtest.run_loadtest(make_service(), requests=50, threads=2)
    assert rep.burst_misses == 1


def test_loadtest_cli_gate(fresh_services):
    common = ["--requests", "100", "--threads", "2", "--discriminant",
              "flops", "--device", "cpu"]
    assert loadtest.main(common + ["--gate-p99-us", "1000000"]) == 0
    assert loadtest.main(common + ["--gate-p99-us", "0.000001"]) == 1
    assert loadtest.DEFAULT_SHAPES == _reference_loadtest().DEFAULT_SHAPES


def _reference_loadtest():
    import importlib.util
    import pathlib
    import sys
    if "loadtest" in sys.modules:
        return sys.modules["loadtest"]
    path = pathlib.Path(__file__).resolve().parent.parent / "tools" / \
        "loadtest.py"
    spec = importlib.util.spec_from_file_location("loadtest", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules["loadtest"] = mod
    spec.loader.exec_module(mod)
    return mod


def test_flops_service_picks_as_the_reference_service(fresh_services):
    mine = _service()
    theirs = JPlanService(discriminant="flops", backend="numpy")
    for family, dims in (("decmlp", (1, 64, 256)), ("decattn",
                                                     (4, 8, 64, 16)),
                         ("decproj", (8, 32, 64))):
        assert mine.lookup(family, dims).ranked == \
            theirs.lookup(family, dims).ranked
    assert isinstance(theirs.planner, JPlanner)
