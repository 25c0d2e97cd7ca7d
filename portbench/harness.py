"""Run one cell of the benchmark once and print its result line.

Everything a cell is made of is found by name: ``BENCHMARK.json`` at
the root names the cell's configuration, its traffic and its metrics;
``configs/<config>.json`` holds the configuration, ``traffic/<traffic>
.json`` the traffic's parameters (with the driver that runs it, the
program's settings and the limits of the comparison), ``drivers/
<driver>.py`` the driver and ``metrics/<metric>.py`` each per-layer
metric's reader.

A run: set-up (the driver's: inputs from the seed, the program built
and warmed on every shape the window uses), then the window (whole
units, begun while ``--seconds`` have not run out), then the comparison
with the plain reference once the program's state is freed.  With
``--trace 1`` the window runs as in an untraced run and the host-clock
per-layer metrics are read from it; then whole units for a further
third of ``--seconds`` run under the profiler, and the device metrics
are read from that traced stretch alone, so the profiler's cost shows
in no host reading.  The last line of standard output is the result;
the numbers compared, each beside its limit, are the last lines of
standard error.
"""

from __future__ import annotations

import argparse
import importlib
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time
import types

import torch

from . import devtrace

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
#: The traced stretch of a ``--trace 1`` run, as a share of ``--seconds``.
TRACED_SHARE = 1 / 3


def _load_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell_spec(name: str, root: pathlib.Path = ROOT) -> dict:
    """The cell ``name`` and everything it names, read from its files."""
    bench = _load_json(root / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; have {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in bench["configs"] if c["name"] == cell["config"])

    def applies(metric):
        return name in metric.get("workloads", [name])

    return {"cell": cell,
            "config": _load_json(root / config["file"]),
            "traffic": _load_json(HERE / "traffic" /
                                  f"{cell['traffic']}.json"),
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


def load_driver(spec: dict, seed: int, device):
    module = importlib.import_module(
        f"portbench.drivers.{spec['traffic']['driver']}")
    return module.Driver(spec["config"], spec["traffic"], seed, device)


def load_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``."""
    path = HERE / "metrics" / f"{name}.py"
    loaded = importlib.util.spec_from_file_location(
        f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(loaded)
    loaded.loader.exec_module(module)
    return module.read


def _launches() -> dict:
    from repro_torch.kernels import ops

    return dict(ops.LAUNCHES)


def _minus(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items()}


def power_limit_w(dev) -> float | None:
    """The card's power limit in watts, as ``nvidia-smi`` reads it
    (None where it cannot be read)."""
    uuid = str(getattr(torch.cuda.get_device_properties(dev), "uuid", ""))
    select = ["-i", uuid if uuid.startswith("GPU-") else f"GPU-{uuid}"] \
        if uuid else []
    try:
        out = subprocess.run(
            ["nvidia-smi", *select, "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=60, check=True).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def run_cell(spec: dict, seed: int, seconds: float, traced: bool,
             device="cuda", t_start: float | None = None) -> dict:
    """One run of a cell: the result's fields, the numbers compared
    last.  ``t_start`` is when the process started (set-up counts from
    it)."""
    t_start = time.perf_counter() if t_start is None else t_start
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    driver = load_driver(spec, seed, dev)
    spans = devtrace.Spans()
    driver.setup(spans)
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    unit = spans.wrap("unit", driver.unit)

    def window(length: float) -> float:
        """Whole units begun within ``length`` seconds; their wall
        time."""
        spans.closed.clear()
        spans.durations.clear()
        t0 = time.perf_counter()
        while True:
            unit()
            if time.perf_counter() - t0 >= length:
                return time.perf_counter() - t0

    cpu0 = time.process_time()
    wall = window(seconds)
    host = types.SimpleNamespace(
        window_s=wall, work=driver.work(),
        spans={k: list(v) for k, v in spans.durations.items()})
    print(f"portbench: setup {setup_s:.3f} s; window {wall:.3f} s "
          f"({time.process_time() - cpu0:.3f} s of host CPU) of "
          f"{len(spans.durations['unit'])} units: "
          f"{[round(d, 3) for d in spans.durations['unit']]}",
          file=sys.stderr)
    trace = None
    if traced:
        work0, launches0 = host.work, _launches()
        tracer = devtrace.DeviceTrace() if cuda else None
        if tracer is not None:
            tracer.start()
        traced_s = window(seconds * TRACED_SHARE)
        if tracer is not None:
            t_read = time.perf_counter()
            tracer.stop()
            print(f"portbench: traced {traced_s:.3f} s of "
                  f"{len(spans.durations['unit'])} units, "
                  f"{len(tracer.kernels)} device operations, read in "
                  f"{time.perf_counter() - t_read:.1f} s", file=sys.stderr)
        trace = types.SimpleNamespace(
            window_s=traced_s, work=_minus(driver.work(), work0),
            launches=_minus(_launches(), launches0),
            kernels=tracer.kernels if tracer is not None else None)
    peak = torch.cuda.max_memory_allocated(dev) if cuda else 0

    out = {"device": {"platform": "gpu" if cuda else dev.type,
                      "kind": torch.cuda.get_device_name(dev) if cuda
                      else dev.type,
                      "count": 1, "memory_peak_bytes": int(peak)}}
    if cuda:
        out["device"]["power_limit_w"] = power_limit_w(dev)
    if traced:
        ctx = types.SimpleNamespace(host=host, trace=trace)
        metrics = {}
        for m in spec["per_layer"]:
            value = load_reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        out["metrics"] = metrics
        if trace.kernels is not None:
            busy = devtrace.busy_seconds(trace.kernels)
            if busy <= 0:
                raise RuntimeError("the trace holds no device time")
            out["device"].update(busy_s=busy, window_s=trace.window_s)
            out["breakdown"] = {
                "device_ops": devtrace.top_ops(trace.kernels),
                "idle_gaps": devtrace.idle_gaps(tracer, spans)}
    else:
        values = dict(driver.end_to_end(wall), setup_s=setup_s)
        out["metrics"] = {m["name"]: {"value": values[m["name"]],
                                      "unit": m["unit"]}
                          for m in spec["end_to_end"]}
        for name, m in out["metrics"].items():
            if not (math.isfinite(m["value"]) and m["value"] > 0):
                raise RuntimeError(f"{name} read {m['value']}")

    driver.release()
    limits = spec["traffic"]["limits"]
    numbers = driver.compared()
    failed = driver.failed(limits)
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    correct = failed == 0 and all(
        math.isfinite(v) and v <= limits[k] for k, v in numbers.items())
    return dict(correct=correct, attempted=int(driver.attempted),
                failed=int(failed), **out, checks=checks)


def forbidden_modules() -> list:
    return sorted({name.split(".")[0] for name in sys.modules} & FORBIDDEN)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, t_start: float | None = None) -> int:
    args = parse(argv)
    spec = cell_spec(args.workload)
    chips = spec["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace),
                      t_start=t_start)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; the port and the harness "
              "may not load JAX or the JAX package", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
