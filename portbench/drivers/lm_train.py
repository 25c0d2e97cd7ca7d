"""Driver of the LM training cells: the port's offloaded train step.

Set-up builds one step object, the way ``launch.train --backend``
wires it: ``build_train_step`` (loss, autograd, the port's AdamW) under
``core.offload`` with the traffic's backend and size gate, on the
benchmark's seeded weights.  It drives that object through its first
``check_steps`` steps, on the first batches of the seeded stream (the
site decisions of the first call and the kernel build fall there), and
hands it to the window, which goes on with the next batches.  A unit is
one step; it ends with the loss on the host.

``correct`` compares two stretches with the plain reference.

* The start: the reference follows the first steps from the same
  weights and batches.  Compared, each by its worst case: the first
  step's loss (relative); the first gradient's norm per leaf, read from
  the program's AdamW state after one step (mu / (1 - b1)), by its
  worst leaf; the norm of each leaf's change over the first steps, by
  its median leaf.  A norm's gap is taken against the reference's norm
  of that leaf or the median leaf's, whichever is larger; a leaf whose
  reference gradient is under a thousandth of the median leaf's moves
  by round-off alone and is left out of the change.  Block leaves count
  per layer.
* The window's last step: each window step keeps the parameters and
  first moments it was handed (the update returns new tensors, so this
  holds a reference, copies nothing and raises no peak).  After the
  window the reference takes one step from those parameters on the
  same batch, in float64: that late in training the float32
  reference's own rounding parts its gradient from float64's by up to
  4.5e-6 in the median leaf, where the program's stays within 2.3e-7
  (PERF.md).  Compared: the step's loss (relative) and its gradient's
  norm by the worst and by the median leaf, the program's gradient
  worked out from its first moments before and after the step
  ((mu' - b1 mu) / (1 - b1)).
  Adam turns rounding into trajectories that part within a few steps,
  so the reference follows the window only from the program's own
  state; the start above is checked from the seed alone.
"""

from __future__ import annotations

import gc
import statistics

import torch
from repro_torch.configs import LMConfig
from repro_torch.core import PrecisionPolicy, offload
from repro_torch.launch.train import build_train_step
from repro_torch.models import Model
from repro_torch.train import AdamW

from .. import inputs
from ..inputs import leaf_items
from ..reference import lm as ref
from ..traffic.generate import synthetic_text
from ..work import lm as lm_work
from ..work import split_gemm


def program_config(config: dict) -> LMConfig:
    """The port's ``LMConfig`` for a configuration file's published
    keys."""
    d, heads = config["hidden_size"], config["num_attention_heads"]
    return LMConfig(
        name=config["name"], vocab_size=config["vocab_size"],
        num_layers=config["num_hidden_layers"], d_model=d,
        num_heads=heads, num_kv_heads=config["num_key_value_heads"],
        head_dim=config.get("head_dim", d // heads),
        d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        rope_theta=config["rope_theta"], norm_eps=config["rms_norm_eps"],
        dtype=config["dtype"], param_dtype=config["dtype"],
        tie_embeddings=config["tie_word_embeddings"])


def program_policy(traffic: dict) -> PrecisionPolicy:
    """The offload's policy for the traffic's backend spec: its pinned
    split count, its size gate."""
    spec = traffic["backend"]
    return PrecisionPolicy(backend=spec, min_dim=traffic["min_dim"],
                           default_splits=split_gemm.splits_of(spec))


def _worst_norm_gap(got: dict, want: dict) -> float:
    median = statistics.median(want.values())
    return max(abs(got[k] - v) / max(v, median) for k, v in want.items())


def gaps(prog: dict, want: dict) -> dict:
    """The numbers compared, from two runs' readings: the first step's
    loss (relative), the worst leaf's gap of first-gradient norms, and
    the median leaf's gap of change norms.  The later steps' losses
    and the worst leaf's change carry Adam's sign-like amplification of
    rounding (PERF.md); they are returned as ``detail``, not compared."""
    loss = [abs(a - b) / abs(b)
            for a, b in zip(prog["losses"], want["losses"])]
    g_med = statistics.median(want["grad1"].values())
    grad = _worst_norm_gap(prog["grad1"], want["grad1"])
    moved = [k for k, v in want["grad1"].items() if v >= 1e-3 * g_med]
    d_med = statistics.median(want["delta"][k] for k in moved)
    delta = [abs(prog["delta"][k] - want["delta"][k])
             / max(want["delta"][k], d_med) for k in moved]
    return {"loss1_rel_gap": loss[0], "grad1_norm_gap": grad,
            "delta_median_gap": statistics.median(delta)}, {
        "loss_rel_gaps": loss, "delta_worst_gap": max(delta),
        "left_out": len(want["grad1"]) - len(moved)}


def last_gaps(prog: dict, want: dict):
    """The numbers compared at the window's last step: its loss
    (relative), the worst and the median leaf's gap of gradient norms;
    and, as ``detail``, the worst leaf and its reference norm over the
    median leaf's."""
    median = statistics.median(want["grad"].values())
    per_leaf = {k: abs(prog["grad"][k] - v) / max(v, median)
                for k, v in want["grad"].items()}
    worst = max(per_leaf, key=per_leaf.get)
    return {"loss_last_rel_gap": abs(prog["loss"] - want["loss"])
            / abs(want["loss"]),
            "grad_last_norm_gap": per_leaf[worst],
            "grad_last_median_gap": statistics.median(per_leaf.values())}, {
        "grad_last_worst_leaf": worst,
        "grad_last_worst_norm_ratio": want["grad"][worst] / median}


def step_grad_norms(mu_after: dict, mu_before: dict, b1: float) -> dict:
    """Per-leaf norms of the gradient an AdamW step took, from its first
    moments before and after the step, in float64."""
    return {name: float(torch.linalg.vector_norm(
                (after.double() - b1 * before.double()) / (1 - b1)))
            for (name, after), (_, before)
            in zip(leaf_items(mu_after), leaf_items(mu_before))}


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.lm = lm_work.LMShape.from_config(config)
        self.batch, self.seq = traffic["batch"], traffic["seq_len"]
        self.steps = 0
        self.window_steps = 0
        self.before_last = None

    def _tokens(self, step: int) -> torch.Tensor:
        return torch.as_tensor(
            synthetic_text(self.lm.vocab, self.seq, self.batch, self.seed,
                           step), device=self.device)

    def _step(self) -> float:
        self.params, self.opt_state, loss = self.step_fn(
            self.params, self.opt_state, self._tokens(self.steps))
        self.steps += 1
        return float(loss)

    def setup(self, spans=None) -> None:
        opt = self.traffic["adamw"]
        self.model = Model(program_config(self.config), device=self.device)
        self.params = inputs.lm_params(self.lm, self.seed, self.device)
        adamw = AdamW(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                      eps=opt["eps"], weight_decay=opt["weight_decay"])
        self.step_fn = offload(build_train_step(self.model, adamw),
                               program_policy(self.traffic))
        self.opt_state = adamw.init(self.params)
        params0 = self.params
        self.readings = {"losses": []}
        for _ in range(self.traffic["check_steps"]):
            self.readings["losses"].append(self._step())
            if self.steps == 1:
                grad = ref.tree_map(lambda m: m / (1 - opt["b1"]),
                                 self.opt_state["mu"])
                self.readings["grad1"] = ref.leaf_norms(grad)
        self.readings["delta"] = ref.leaf_norms(ref.tree_map(
            lambda p, q: p - q, self.params, params0))

    def unit(self) -> None:
        self.before_last = (self.params, self.opt_state["mu"], self.steps)
        self.last_loss = self._step()
        self.window_steps += 1

    def end_to_end(self, wall_s: float) -> dict:
        tokens = self.window_steps * self.batch * self.seq
        return {"train_tokens_per_s": tokens / wall_s}

    def work(self) -> dict:
        gemms = lm_work.emulated(
            lm_work.train_gemms(self.lm, self.batch, self.seq),
            self.traffic["min_dim"])
        s = split_gemm.splits_of(self.traffic["backend"])
        n = self.window_steps
        return {"train_model_flops": n * lm_work.train_flops(
                    self.lm, self.batch, self.seq),
                "train_k1_bound_s": n * split_gemm.k1_bound_s(
                    lm_work.expand(gemms), s),
                "train_real_gemms": n * sum(gemms.values())}

    def release(self) -> None:
        """Read the last window step, keep the parameters it was handed
        and free the rest of the program's state."""
        params, mu, step = self.before_last
        self.readings["last"] = {
            "loss": self.last_loss,
            "grad": step_grad_norms(self.opt_state["mu"], mu,
                                    self.traffic["adamw"]["b1"])}
        self.before_last = (params, step)
        del self.model, self.step_fn, self.params, self.opt_state, mu
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, rows=None) -> dict:
        """The plain reference's readings over the first steps (``tf32``:
        the lower-precision control; ``rows``: each loss over the first
        ``rows`` positions only, a planted fault)."""
        params0 = inputs.lm_params(self.lm, self.seed, self.device)
        batches = [self._tokens(i)
                   for i in range(self.traffic["check_steps"])]
        return ref.train(params0, batches, self.lm, self.config,
                         self.traffic["adamw"], tf32=tf32, rows=rows)

    def reference_last(self, tf32: bool = False, rows=None,
                       dtype=torch.float32) -> dict:
        """The plain reference's loss and gradient norms at the window's
        last step, from the parameters the program's step was handed
        (``tf32``, ``rows``: as for ``reference``; ``dtype``: the type
        the reference runs in)."""
        params, step = self.before_last
        out = ref.train(params, [self._tokens(step)], self.lm, self.config,
                        self.traffic["adamw"], tf32=tf32, rows=rows,
                        dtype=dtype)
        return {"loss": out["losses"][0], "grad": out["grad1"]}

    def compared(self, control: bool = False) -> dict:
        """The numbers compared (``control``: the TF32 reference's, put
        in the program's place)."""
        want = self.reference()
        prog = self.reference(tf32=True) if control else self.readings
        self.attempted = len(prog["losses"]) + self.window_steps
        self.numbers, self.detail = gaps(prog, want)
        want = self.reference_last(dtype=torch.float64)
        prog = self.reference_last(tf32=True) if control \
            else self.readings["last"]
        numbers, detail = last_gaps(prog, want)
        self.numbers.update(numbers)
        self.detail.update(detail, last_step=self.before_last[1] + 1,
                           loss_last=want["loss"])
        return self.numbers

    def failed(self, limits: dict) -> int:
        """Numbers over their limits."""
        return sum(v > limits[k] for k, v in self.numbers.items())
