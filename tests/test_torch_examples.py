"""The port's command-line entry points on the CPU at the tiny preset.

``python -m repro_torch.launch.serve`` and the four
``examples/torch_*.py`` scripts against the reference's examples
workflow: a checkpoint the reference's trainer wrote served by the
port's launcher with the reference engine's streams, the port's own
train -> serve handoff, the restore-failure path, the warm restart that
``obs report --check --expect-cache-hit`` accepts, a live ``/metrics``
scrape, the quickstart's ladder gate and the MuST study's gates.
"""

import os
import subprocess
import sys
import urllib.request
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "examples"))

import torch_must_greens_function  # noqa: E402
import torch_quickstart  # noqa: E402
import torch_serve_lm  # noqa: E402
import torch_train_lm  # noqa: E402

from repro_torch.launch import serve  # noqa: E402
from repro_torch.obs import cli as obs_cli  # noqa: E402

torch.set_num_threads(1)

QUIET = ["--metrics-dir", "none"]


def _tokens(done):
    return [list(r.out) for r in done]


def _reference_streams(ckpt_dir, max_new, temperature=0.0):
    """``examples/serve_lm.py``'s body on the reference engine, tiny
    preset, restored from ``ckpt_dir``."""
    from repro.configs.base import get_config
    from repro.models.lm import Model
    from repro.serve.engine import Engine, Request
    from repro.train import checkpoint as CK
    from repro.train.optimizer import AdamW

    cfg = get_config("tiny")
    model = Model(cfg)
    params = model.init_params(jax.random.PRNGKey(0))
    last = CK.latest_step(ckpt_dir)
    params, _ = CK.restore(ckpt_dir, last, (params, AdamW().init(params)))
    engine = Engine(model, params, batch_slots=4, max_len=512)
    rng = np.random.default_rng(0)
    reqs = [Request(prompt=[int(t) for t in
                            rng.integers(1, cfg.vocab_size, 16)],
                    max_new_tokens=max_new, temperature=temperature,
                    seed=i)
            for i in range(4)]
    return [list(r.out) for r in engine.run(reqs)]


@pytest.fixture(scope="module")
def reference_ckpt(tmp_path_factory):
    """Four steps of the reference's trainer, tiny preset."""
    from repro.launch.train import main as train_ref

    ckpt = tmp_path_factory.mktemp("ref") / "ckpt"
    train_ref(["--arch", "tiny", "--steps", "4", "--seq-len", "64",
               "--global-batch", "4", "--ckpt-dir", str(ckpt),
               "--log-every", "10", "--metrics-dir", "none"])
    return ckpt


@pytest.fixture(scope="module")
def port_ckpt(tmp_path_factory):
    """Four emulated steps of ``examples/torch_train_lm.py``."""
    ckpt = tmp_path_factory.mktemp("port") / "ckpt"
    losses = torch_train_lm.main(["--preset", "tiny", "--steps", "4",
                                  "--backend", "fp64_int8_4", "--device",
                                  "cpu", "--ckpt-dir", str(ckpt)])
    assert len(losses) == 4 and losses[-1] < losses[0]
    return ckpt


class TestServeLauncher:
    @pytest.mark.parametrize("temperature", [0.0, 0.8])
    def test_reference_checkpoint_serves_reference_streams(
            self, reference_ckpt, temperature, capsys):
        done = serve.main(["--arch", "tiny", "--ckpt-dir",
                           str(reference_ckpt), "--max-new-tokens", "8",
                           "--temperature", str(temperature)] + QUIET,
                          device="cpu")
        out = capsys.readouterr().out
        assert "[serve] loading checkpoint step 4" in out
        assert "restore failed" not in out
        assert _tokens(done) == _reference_streams(reference_ckpt, 8,
                                                   temperature)

    def test_port_train_to_serve_handoff(self, port_ckpt, capsys):
        done = torch_serve_lm.main(["--preset", "tiny", "--ckpt-dir",
                                    str(port_ckpt), "--device", "cpu",
                                    "--max-new-tokens", "8"])
        out = capsys.readouterr().out
        assert "[serve] loading checkpoint step 4" in out
        assert "restore failed" not in out
        assert "[serve] OK" in out
        assert [len(r.out) for r in done] == [8] * 4
        # Telemetry on by default, beside the trainer's runs.
        assert sorted(os.listdir(port_ckpt / "metrics")) == [
            "events-0000.jsonl", "events-0001.jsonl"]

    def test_restore_failure_serves_seed_parameters(self, tmp_path,
                                                    capsys):
        other = tmp_path / "other"
        torch_train_lm.main(["--preset", "tiny", "--steps", "1",
                             "--device", "cpu", "--ckpt-dir", str(other)])
        capsys.readouterr()
        argv = ["--max-new-tokens", "4", "--overrides",
                '{"num_layers": 1}'] + QUIET
        done = serve.main(["--arch", "tiny", "--ckpt-dir", str(other)]
                          + argv, device="cpu")
        out = capsys.readouterr().out
        assert "loading checkpoint step 1" in out
        assert "[serve] restore failed (" in out
        assert "[serve] OK" in out
        fresh = serve.main(["--arch", "tiny", "--ckpt-dir",
                            str(tmp_path / "none")] + argv, device="cpu")
        assert _tokens(done) == _tokens(fresh)

    def test_warm_restart_is_a_cache_hit(self, port_ckpt, tmp_path):
        argv = ["--arch", "tiny", "--ckpt-dir", str(port_ckpt),
                "--splits", "6", "--min-dim", "64", "--max-new-tokens", "4",
                "--warm-cache-dir", str(tmp_path / "cache"),
                "--metrics-dir", str(tmp_path / "metrics")]
        args, engine, reqs = serve.build(argv, device="cpu")
        # The one prefill wave: 4 prompts of 16 tokens, offloaded.
        assert any(s.offloaded for s in engine.prefill_sites(4, 16))
        first = serve.run(args, engine, reqs)
        metrics = str(tmp_path / "metrics")
        check = ["report", metrics, "--check", "--expect-cache-hit"]
        assert obs_cli.main(check, out=open(os.devnull, "w")) != 0
        second = serve.main(argv, device="cpu")
        assert _tokens(first) == _tokens(second)
        assert obs_cli.main(check, out=open(os.devnull, "w")) == 0

    def test_live_metrics_scrape(self, port_ckpt, tmp_path):
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        proc = subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.serve", "--device",
             "cpu", "--arch", "tiny", "--ckpt-dir", str(port_ckpt),
             "--splits", "6", "--min-dim", "64", "--max-new-tokens", "4",
             "--warm-cache-dir", str(tmp_path / "cache"),
             "--metrics-dir", str(tmp_path / "live"),
             "--latency-target-s", "120", "--scheduler-policy", "edf",
             "--metrics-port", "0", "--hold-metrics-s", "30"],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env, cwd=tmp_path)
        try:
            url = None
            for line in proc.stdout:
                if "live metrics: " in line:
                    url = line.split("live metrics: ")[1].strip()
                if "holding /metrics" in line:
                    break
            assert url is not None
            text = urllib.request.urlopen(url, timeout=30).read().decode()
        finally:
            proc.kill()
            proc.wait(timeout=30)
        names = {line.split("{")[0].split(" ")[0]
                 for line in text.splitlines() if not line.startswith("#")}
        for series in ("serve_ttft", "transform_cache", "slo_burn_rate"):
            assert any(n.startswith(series) for n in names), series

    def test_without_a_card_it_raises(self, tmp_path):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is used")
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        out = subprocess.run(
            [sys.executable, "-m", "repro_torch.launch.serve", "--arch",
             "tiny", "--metrics-dir", "none"], capture_output=True,
            text=True, env=env, cwd=tmp_path, timeout=120)
        assert out.returncode != 0
        assert "no CUDA device" in out.stderr
        assert "[serve] OK" not in out.stdout


class TestStudies:
    def test_quickstart_ladder_falls(self, capsys):
        errs = torch_quickstart.main(["--device", "cpu"])
        assert len(errs) == 7
        assert all(b < a for a, b in zip(errs, errs[1:]))
        assert "[quickstart] OK" in capsys.readouterr().out

    def test_must_gates(self, tmp_path):
        errors, ref = torch_must_greens_function.main(
            ["--device", "cpu", "--n", "96", "--block", "24", "--energies",
             "9", "--splits", "3", "6", "9", "--outdir", str(tmp_path)])
        ladder = [errors[f"fp64_int8_{s}"]["max_real"] for s in (3, 6, 9)]
        assert ladder[0] > ladder[1] > ladder[2]
        dist = np.abs(ref["z"].real - 0.72)
        peak = int(np.argmax(errors["fp64_int8_6"]["per_z_real"]))
        assert dist[peak] == dist.min()
        table = (tmp_path / "table1.csv").read_text().splitlines()
        assert table[0].startswith("mode,max_real")
        assert len(table) == 4
        assert (tmp_path / "fig1.csv").exists()
