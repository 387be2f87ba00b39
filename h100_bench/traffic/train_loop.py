"""Traffic ``train_loop``: the program's training loop, timed by its own
``on_step`` hook.

Set-up builds one training run: ``repro_torch.train.loop.train`` on the
benchmark's weights (drawn from the seed and copied into the loop's
fresh state by name) and on zipf token batches drawn from the seed. Its
first ``check_steps`` steps are set-up: the first is the capture's eager
warm-up, the others replays of the captured step, each on its own rows.
After step 0 the harness reads each leaf's first gradient from AdamW's
first moment, and after the last of them each leaf's change; the
reference runs the same steps once the window has closed. The window then
times the same loop's next steps until ``seconds`` have passed, and the
``on_step`` hook ends the run by raising.

A ``--trace 1`` run also keeps the program's spans and counters: a
``repro_torch.runtime.spans.Recorder`` is active around the loop (its
marks ride in the captured graph, so a traced step reads a little
longer), and the ``SPAN_STEPS`` window steps after the profiler's
window are read (``collect`` in the hook, outside a step's wall). With
``--trace 0`` no recorder is made, and the graph holds the program's
kernels alone.

Mix parameters: ``batch``, ``seq_len``, ``peak_lr``, ``warmup``,
``total_steps`` (the schedule's length; the window ends the run long
before), ``zipf_a``, ``check_steps``, ``trace_steps`` (steps in the traced
window of a ``--trace 1`` run).
"""

from __future__ import annotations

import contextlib
import gc
import statistics
import time
from typing import Dict, List

import numpy as np

from h100_bench import reference, weights
from h100_bench.reference import train as ref_train
from h100_bench.trace import Tracer


class ZipfTokens:
    """Zipf-distributed tokens with next-token labels, a row a pure
    function of (seed, global row id): the arithmetic of the program's
    ``data.SyntheticLM``, kept here so that the benchmark makes its own
    inputs."""

    def __init__(self, vocab: int, seq_len: int, batch: int, seed: int,
                 zipf_a: float):
        self.vocab, self.seq, self.batch = vocab, seq_len, batch
        self.seed, self.zipf_a = seed, zipf_a

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        toks = np.empty((self.batch, self.seq + 1), dtype=np.int32)
        for i in range(self.batch):
            rng = np.random.default_rng(np.random.SeedSequence(
                [self.seed, step * self.batch + i]))
            toks[i] = (rng.zipf(self.zipf_a, size=self.seq + 1) - 1) \
                % self.vocab
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


class _WindowClosed(Exception):
    pass


#: Window steps whose device spans a traced run reads, after the
#: profiler's window: enough for a median that one odd step does not
#: move, few because each read costs some 5 ms of host time in the hook.
SPAN_STEPS = 8


def span_recorder(ctx):
    """A span recorder for a traced run; None for an untraced one, or
    where the program has no ``repro_torch.runtime.spans``."""
    if not ctx.trace:
        return None
    try:
        from repro_torch.runtime import spans
    except ImportError:
        return None
    return spans.Recorder(ctx.device)


def run(ctx) -> dict:
    import torch
    from repro_torch.train import loop as loop_mod

    mix, cfg, device = ctx.params, ctx.cfg, ctx.device
    opt = dict(cfg["optimizer"], peak_lr=mix["peak_lr"],
               warmup=mix["warmup"], total_steps=mix["total_steps"])
    source = ZipfTokens(cfg["vocab"], mix["seq_len"], mix["batch"],
                        ctx.seed, mix["zipf_a"])
    spec = reference.family(cfg).param_spec(cfg)
    n_check = mix["check_steps"]
    tracer = Tracer(ctx.trace)
    recorder = span_recorder(ctx)
    held: Dict[str, object] = {"p0": weights.make(spec, ctx.seed, device)}
    rec: Dict[str, object] = {"kind": "train", "losses": [],
                              "step_walls": [], "traced_walls": [],
                              "trace_steps": 0, "span_steps": [],
                              "failed": 0}

    def make_state(*args, **kwargs):
        state = original(*args, **kwargs)
        weights.load(state.params, held["p0"])
        held["state"] = state
        return state

    def leaf_norms(tensors, scale=1.0):
        names = list(tensors)
        vals = torch.stack([torch.linalg.vector_norm(tensors[n].float())
                            for n in names]).tolist()
        return {n: v * scale for n, v in zip(names, vals)}

    def on_step(step: int, metrics: Dict[str, float], wall: float) -> None:
        now = time.perf_counter()
        state = held["state"]
        if step < n_check:
            rec["losses"].append(metrics["loss"])
            if step == 0:
                rec["first_grad"] = leaf_norms(
                    state.opt.mu, 1.0 / (1.0 - opt["b1"]))
            if step == n_check - 1:
                p0 = held.pop("p0")
                rec["change"] = leaf_norms(
                    {n: state.params[n] - p0[n] for n in p0})
                del p0
                rec["setup_s"] = time.perf_counter() - ctx.t_process
                rec["t_window"] = time.perf_counter()
            return
        rec["step_walls"].append(wall)
        rec["failed"] += not np.isfinite(metrics["loss"])
        done = len(rec["step_walls"])
        if recorder is not None and tracer.summary is not None and \
                len(rec["span_steps"]) < SPAN_STEPS:
            recorder.collect()
            rec["span_steps"].append(step)
        if done == 1:
            tracer.start("after_on_step")
        elif tracer.active:
            rec["traced_walls"].append(wall)
            rec["trace_steps"] += 1
            if rec["trace_steps"] == mix["trace_steps"]:
                tracer.stop()
            else:
                tracer.mark("after_on_step")
        if now - rec["t_window"] >= ctx.seconds:
            rec["window_s"] = now - rec["t_window"]
            rec["window_steps"] = done
            raise _WindowClosed

    original = loop_mod.make_train_state
    loop_mod.make_train_state = make_state
    try:
        with recorder or contextlib.nullcontext():
            loop_mod.train(ctx.port_cfg, source, mix["total_steps"],
                           optimizer=cfg["optimizer"]["name"],
                           peak_lr=mix["peak_lr"], warmup=mix["warmup"],
                           log_every=1 << 40, seed=ctx.seed,
                           log_fn=lambda _: None, on_step=on_step,
                           device=device)
        raise RuntimeError("the training loop ended before the window did")
    except _WindowClosed:
        pass
    finally:
        loop_mod.make_train_state = original
        tracer.stop()
    held.clear()
    rec["window_tokens"] = rec["window_steps"] * mix["batch"] * mix["seq_len"]
    rec["attempted"] = rec["window_steps"]
    rec["memory_peak_bytes"] = ctx.memory_peak()
    rec["trace"] = tracer.summary
    if recorder is not None:
        rec["spans"] = {
            "device": recorder.summary("device", steps=rec["span_steps"]),
            "host": recorder.summary("host")}
        rec["counts"] = dict(recorder.counts)
    gc.collect()
    ctx.free_device()
    rec["checks"] = _checks(ctx, cfg, spec, source, opt, n_check, rec)
    if rec["traced_walls"]:
        # the profiler's own cost: the traced steps' walls beside the rest
        untraced = [w for i, w in enumerate(rec["step_walls"])
                    if not 1 <= i <= len(rec["traced_walls"])]
        rec["detail"]["traced_step_wall_ms"] = [
            w * 1e3 for w in rec["traced_walls"]]
        rec["detail"]["untraced_step_wall_ms"] = \
            statistics.median(untraced) * 1e3 if untraced else None
    if "spans" in rec:
        rec["detail"]["spans"] = {
            clock: {name: [v["total_ms"], v["self_ms"]]
                    for name, v in by.items()}
            for clock, by in rec["spans"].items()}
        rec["detail"]["counts"] = rec["counts"]
        rec["detail"]["span_steps"] = rec["span_steps"]
    return rec


def reference_batches(source: ZipfTokens, n: int, device):
    import torch
    out = []
    for k in range(n):
        b = source.batch_at(k)
        out.append((torch.from_numpy(b["tokens"]).long().to(device),
                    torch.from_numpy(b["labels"]).long().to(device)))
    return out


def _checks(ctx, cfg, spec, source, opt, n_check, rec) -> Dict[str, float]:
    """The reference's ``n_check`` steps from the same weights on the same
    batches, against the program's readings."""
    from h100_bench.reference.common import Precision, strict_float32
    strict_float32()
    p0 = weights.make(spec, ctx.seed, ctx.device)
    batches = reference_batches(source, n_check, ctx.device)
    ref = ref_train.run_steps(cfg, p0, batches, opt)
    if ctx.control:
        rec["control"] = compare(ref_train.run_steps(
            cfg, p0, batches, opt, Precision("fp8")), ref)
    del p0
    rec["detail"] = {}
    return compare(rec, ref, rec["detail"])


def compare(prog: dict, ref: dict, detail: dict = None) -> Dict[str, float]:
    """The three numbers compared: the largest loss gap over the checked
    steps, and the worst leaf's gap of the first gradient's norm and of
    the change's norm (leaves that the reference does not move left
    out); beside each worst leaf's gap, the median leaf's, steady from
    seed to seed. ``detail`` receives the five worst leaves of each."""
    losses: List[float] = prog["losses"]
    loss_gap = max(abs(a - b) for a, b in zip(losses, ref["losses"]))
    if len(losses) != len(ref["losses"]) or not np.isfinite(losses).all():
        loss_gap = float("inf")
    out = {"loss_gap": loss_gap}
    for key, name, leaves in (
            ("first_grad", "grad_gap", list(ref["first_grad"])),
            ("change", "update_gap",
             ref_train.moving_leaves(ref["first_grad"]))):
        gaps = ref_train.leaf_gaps(prog[key], ref[key], leaves)
        out[name] = max(gaps.values())
        out[name + "_median"] = statistics.median(gaps.values())
        if detail is not None:
            detail[name] = sorted(gaps.items(), key=lambda kv: -kv[1])[:5]
    return out
