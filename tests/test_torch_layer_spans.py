"""The port's layer spans (``repro_torch.obs.trace``): what a train step
under the offload records while a tracer is active, and that nothing is
recorded and nothing changes while none is.

A tiny LM's step under ``offload(..., "pallas_int8_4")`` on the CPU
(the kernel wrappers run their plain versions there): one
``train.step`` a step holding its ``train.forward``, ``train.backward``
and ``train.optimizer``; one ``offload.site`` per execution the
offload's hook counts; one ``ozaki`` per ``ozaki_matmul`` call holding
one ``ozaki.slice``, ``ozaki.kernel`` and ``ozaki.combine``.
"""

import io
import json
from collections import Counter

import pytest
import torch

from repro_torch.configs import get_config
from repro_torch.core import PrecisionPolicy, offload
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import Model
from repro_torch.obs import MetricsRun, trace
from repro_torch.train import AdamW, SyntheticText

STEPS = 2


def _step_fn(on_site_event=None):
    cfg = get_config("tiny").replace(num_layers=2)
    model = Model(cfg, device="cpu", seed=0)
    opt = AdamW(lr=3e-3)
    step = offload(train.build_train_step(model, opt),
                   PrecisionPolicy(backend="pallas_int8_4", min_dim=64),
                   on_site_event=on_site_event)
    data = SyntheticText(cfg.vocab_size, 32, 2, seed=0)
    return step, model.params, opt.init(model.params), data


def _run(step, params, state, data):
    losses = []
    for i in range(STEPS):
        params, state, loss = step(params, state,
                                   torch.as_tensor(data.batch(i)))
        losses.append(loss)
    return params, state, losses


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def _children(spans, parent, name):
    return [s for s in spans if s["name"] == name and _inside(s, parent)]


@pytest.fixture(scope="module")
def traced_run():
    """Two steps under an active tracer: the spans, the hook's count,
    the kernel calls and the step's outputs."""
    hooked = []
    step, params, state, data = _step_fn(hooked.append)
    step(params, state, torch.as_tensor(data.batch(0)))   # decide sites
    hooked.clear()
    calls = []
    kmajor = ops.split_gemm_kmajor

    def counted(*args, **kwargs):
        calls.append(1)
        return kmajor(*args, **kwargs)

    tracer = trace.Tracer()
    with pytest.MonkeyPatch.context() as patch:
        patch.setattr(ops, "split_gemm_kmajor", counted)
        with trace.activate(tracer):
            out = _run(step, params, state, data)
    return tracer.events, len(hooked), len(calls), out


def test_a_step_holds_its_phases(traced_run):
    spans = traced_run[0]
    steps = [s for s in spans if s["name"] == "train.step"]
    assert len(steps) == STEPS
    for step in steps:
        for phase in ("train.forward", "train.backward", "train.optimizer"):
            assert len(_children(spans, step, phase)) == 1, phase
    names = Counter(s["name"] for s in spans)
    assert all(names[p] == STEPS for p in
               ("train.forward", "train.backward", "train.optimizer"))
    assert all(ev["type"] == "span" and set(ev) == {
        "type", "name", "ts", "dur", "tid", "args"} for ev in spans)


def test_one_offload_site_per_hooked_execution(traced_run):
    spans, hooked, _, _ = traced_run
    sites = [s for s in spans if s["name"] == "offload.site"]
    assert hooked > 0
    assert len(sites) == hooked
    # Backward sites too: the step's products and their cotangents.
    assert len(sites) > 2 * STEPS


def test_one_ozaki_per_call_with_its_parts(traced_run):
    spans, hooked, calls, _ = traced_run
    ozaki = [s for s in spans if s["name"] == "ozaki"]
    assert len(ozaki) == calls == hooked
    sites = [s for s in spans if s["name"] == "offload.site"]
    for call in ozaki:
        for part in ("ozaki.slice", "ozaki.kernel", "ozaki.combine"):
            assert len(_children(spans, call, part)) == 1, part
        assert sum(_inside(call, site) for site in sites) == 1
    parts = Counter(s["name"] for s in spans
                    if s["name"].startswith("ozaki."))
    assert parts == {p: calls for p in
                     ("ozaki.slice", "ozaki.kernel", "ozaki.combine")}


def test_no_tracer_no_spans_same_outputs(traced_run, monkeypatch):
    """With no tracer active no span is opened, and the step's outputs
    are bitwise the traced step's."""
    def refuse(*args, **kwargs):
        raise AssertionError("a span opened with no tracer active")

    monkeypatch.setattr(trace.Tracer, "span", refuse)
    assert trace.active() is None
    step, params, state, data = _step_fn()
    step(params, state, torch.as_tensor(data.batch(0)))
    got = _run(step, params, state, data)
    want = traced_run[3]
    flat_got, _ = torch.utils._pytree.tree_flatten(got)
    flat_want, _ = torch.utils._pytree.tree_flatten(want)
    assert len(flat_got) == len(flat_want)
    for a, b in zip(flat_got, flat_want):
        assert torch.equal(a, b)


def test_activate_restores_the_earlier_tracer():
    outer, inner = trace.Tracer(), trace.Tracer()
    with trace.activate(outer):
        with pytest.raises(RuntimeError):
            with trace.activate(inner):
                assert trace.active() is inner
                with trace.span("inner.work"):
                    raise RuntimeError("boom")
        assert trace.active() is outer
        with trace.span("outer.work", k=1):
            pass
    assert trace.active() is None
    assert trace.span("off") is trace.span("off too")   # the shared no-op
    assert [(e["name"], e["args"]) for e in inner.events] == [
        ("inner.work", {"error": True})]
    assert [(e["name"], e["args"]) for e in outer.events] == [
        ("outer.work", {"k": 1})]


def test_active_spans_are_held_until_the_block_ends(tmp_path):
    """A tracer over a sink writes nothing while it is active; its
    spans reach the file when the outermost block ends."""
    run = MetricsRun(tmp_path, run_id="0000")

    def spans_on_disk():
        return [json.loads(line)["name"] for line in
                (tmp_path / "events-0000.jsonl").read_text().splitlines()
                if json.loads(line)["type"] == "span"]

    with trace.activate(run.tracer):
        with trace.span("ozaki"):
            pass
        with run.tracer.span("train_step", step=1):
            pass
        assert spans_on_disk() == []
        assert len(run.tracer.events) == 2
    assert spans_on_disk() == ["ozaki", "train_step"]
    assert run.tracer.events == []
    with run.tracer.span("after"):   # streamed again once inactive
        pass
    assert spans_on_disk()[-1] == "after"
    run.close()


def test_anchor_maps_a_span_onto_the_perf_counter_clock():
    tracer = trace.Tracer()
    before = trace.time.perf_counter_ns()
    with tracer.span("x"):
        pass
    after = trace.time.perf_counter_ns()
    ev = tracer.events[0]
    start = tracer.t0_ns + ev["ts"] * 1e3
    assert before - 1e3 <= start <= start + ev["dur"] * 1e3 <= after + 1e3


def _cli(tmp_path, *extra):
    ckpt = tmp_path / "ckpt"
    train.main(["--device", "cpu", "--arch", "tiny", "--overrides",
                '{"num_layers": 1}', "--steps", "2", "--seq-len", "32",
                "--global-batch", "2", "--backend", "pallas_int8_4",
                "--min-dim", "64", "--numerics-every", "0", "--ckpt-dir",
                str(ckpt), *extra])
    lines = [json.loads(line) for line in
             (ckpt / "metrics" / "events-0000.jsonl").read_text()
             .splitlines()]
    return ckpt / "metrics", Counter(ev["name"] for ev in lines
                                     if ev["type"] == "span")


def test_layer_spans_switch(tmp_path):
    from repro_torch.obs import cli

    _, plain = _cli(tmp_path / "off")
    assert plain == {"train_step": 2}
    metrics, spans = _cli(tmp_path / "on", "--layer-spans")
    assert spans["train_step"] == spans["train.step"] == 2
    assert spans["ozaki"] == spans["ozaki.kernel"] == spans["offload.site"]
    assert spans["ozaki"] > 0
    out = tmp_path / "trace.json"
    assert cli.main(["export", str(metrics), "-o", str(out)],
                    out=io.StringIO()) == 0
    names = Counter(ev["name"] for ev in
                    json.loads(out.read_text())["traceEvents"])
    assert names["ozaki.slice"] == spans["ozaki.slice"]
    with pytest.raises(SystemExit):
        train.main(["--device", "cpu", "--arch", "tiny", "--layer-spans",
                    "--metrics-dir", "none", "--ckpt-dir",
                    str(tmp_path / "none")])
