"""Driver of the expert-model training cells: the port's offloaded train
step on ``MoEModel`` (the Mellum2 configuration).

As ``lm_train`` drives the dense model, and with its comparison
(``gaps``, ``last_gaps``, ``step_grad_norms``): set-up builds the step
the way ``launch.train --backend`` wires it (``build_train_step`` under
``core.offload`` with the traffic's backend and size gate) on the
benchmark's seeded weights (``inputs_moe.moe_params``; the model is
built with ``seed=None`` and holds no weights of its own), drives it
through the first ``check_steps`` steps of the seeded stream, and hands
it to the window.  A unit is one step; it ends with the loss on the
host.

``correct`` compares the first steps with the plain reference
(``reference/moe_lm.py``) from the same weights and batches, as
``lm_train`` takes them (``gaps``), and the window's last step with a
float64 reference step from the parameters and AdamW moments the
program's step was handed.  Over the first steps, the first loss and
gradient are held to the reference run in float32, whose rounding the
program shares outside its products; the change after the last of them
is held to the reference run in float64.  Adam carries float32's
rounding of the first steps into a change of every leaf, and on a rare
seed (1875333606, whose loss went 11.9, 10.2, 25.0) the float32
reference itself parts from float64 by 1.8e-4 in the median leaf's
change, where the program parts from it by 1.4e-5 (on an H100;
PERF.md).  The float32 reference's gap is kept as ``detail``
(``delta_median_gap_f32``).  Both reference runs route each token to the
experts the program routed it to (``MoEModel.routing`` of each step
compared): top-k is discontinuous, and where a token's k-th and
(k+1)-th probabilities lie within rounding, two sound computations send
it to different experts (on an H100, one seed in ten at the first step,
where it moved the worst leaf's first gradient by up to 4.5e-4).  That
the program's choice is the top-k is checked apart, at each checked
step: ``route_margin``, the largest amount by which a float64 forward
of the parameters that step was handed, following the program's
routing, gives an expert the program did not choose a higher
probability than one it chose (``reference.moe_lm.route_margin``, run
in set-up, the one time those parameters are held).  The start
reference cannot witness steps 2 and 3: its own parameters part from
the program's after step 1, as Adam turns rounding into trajectories
that part.  At the window's last step the float64 forward of the
program's own parameters reads margins up to 0.31 on sound runs of the
ill-conditioned seeds (PERF.md §2), so that step's margin is kept as
``detail`` (``route_last_margin``) and not compared.  A routing that
does not cover the batch's tokens, at any step compared, makes
``route_margin`` infinite.

Late in the window this model (lr 3e-3) is ill-conditioned: float32
itself, the reference's, parts from float64 there by up to 7.1e-4 in
the loss and 0.60 in the median leaf's gradient norm (on an H100;
PERF.md), and no limit on the loss or the gradient there lies between
sound runs and the TF32 control.  So the window's step is held to what
its AdamW step did with that gradient: ``delta_last_median_gap``, the
median leaf's gap between the norm of the program's change of the
parameters and that of the float64 step's change from the same moments.
Adam's normalised update barely follows the gradient's size: on an H100
sound runs read at most 2.5e-3 there, on the ill-conditioned seeds
too, and a step that leaves the state unchanged reads 1.0 (PERF.md
§2).  ``lm_train``'s numbers at that step (``last_gaps``) are kept as
``detail``.

The work counted for the per-layer metrics reads the program's
``ExpertCounter`` (``model.counter``): the tokens routed to each held
expert in each layer and step of the window size the experts' products,
which change every step, and its host nanoseconds give the time spent
in the expert layers.
"""

from __future__ import annotations

import gc
import math
import statistics

import torch
from repro_torch.configs import LMConfig
from repro_torch.core import offload
from repro_torch.launch.train import build_train_step
from repro_torch.models.moe import MoEModel
from repro_torch.train import AdamW

from .. import inputs_moe
from ..reference import lm as ref_lm
from ..reference import moe_lm as ref
from ..traffic.generate import synthetic_text
from ..work import lm as lm_work
from ..work import moe_lm as moe_work
from ..work import split_gemm
from .lm_train import gaps, last_gaps, program_policy, step_grad_norms


def program_config(config: dict) -> LMConfig:
    """The port's ``LMConfig`` for a configuration file's published keys
    (``num_experts`` counts the experts held here: the first of
    ``held_experts``; the router scores ``router_experts``)."""
    layers = config["num_hidden_layers"]
    rope = config["rope_parameters"]
    full, sliding = rope["full_attention"], rope["sliding_attention"]
    if full["rope_theta"] != sliding["rope_theta"]:
        raise ValueError("the port's LM takes one rope_theta for both "
                         "layer kinds")
    yarn = full if full["rope_type"] == "yarn" else {}
    return LMConfig(
        name=config["name"], vocab_size=config["vocab_size"],
        num_layers=layers, d_model=config["hidden_size"],
        num_heads=config["num_attention_heads"],
        num_kv_heads=config["num_key_value_heads"],
        head_dim=config["head_dim"], d_ff=config["intermediate_size"],
        max_seq_len=config["max_position_embeddings"],
        rope_theta=float(sliding["rope_theta"]),
        norm_eps=config["rms_norm_eps"], dtype=config["dtype"],
        param_dtype=config["dtype"],
        tie_embeddings=config["tie_word_embeddings"],
        layer_pattern=tuple(kind.split("_")[0]
                            for kind in config["layer_types"][:layers]),
        sliding_window=config["sliding_window"],
        yarn_factor=float(yarn.get("factor", 0.0)),
        yarn_original_max_positions=yarn.get(
            "original_max_position_embeddings", 0),
        yarn_beta_fast=float(yarn.get("beta_fast", 32.0)),
        yarn_beta_slow=float(yarn.get("beta_slow", 1.0)),
        yarn_attention_factor=float(yarn.get("attention_factor", 0.0)),
        num_experts=config["router_experts"],
        experts_held=tuple(config["held_experts"][:config["num_experts"]]),
        num_experts_per_tok=config["num_experts_per_tok"],
        moe_d_ff=config["moe_intermediate_size"],
        norm_topk_prob=config["norm_topk_prob"])


class Driver:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic = config, traffic
        self.seed, self.device = seed, torch.device(device)
        self.shape = moe_work.MoEShape.from_config(config)
        self.batch, self.seq = traffic["batch"], traffic["seq_len"]
        self.steps = 0
        self.window_steps = 0
        self.before_last = None
        # The counter's position when the window began: its records
        # from there on are the window's.
        self.window_from = None

    def _tokens(self, step: int) -> torch.Tensor:
        return torch.as_tensor(
            synthetic_text(self.shape.vocab, self.seq, self.batch,
                           self.seed, step), device=self.device)

    def _step(self) -> float:
        self.params, self.opt_state, loss = self.step_fn(
            self.params, self.opt_state, self._tokens(self.steps))
        self.steps += 1
        return float(loss)

    def setup(self, spans=None) -> None:
        opt = self.traffic["adamw"]
        self.model = MoEModel(program_config(self.config),
                              device=self.device, seed=None)
        self.params = inputs_moe.moe_params(self.shape, self.seed,
                                            self.device)
        adamw = AdamW(lr=opt["lr"], b1=opt["b1"], b2=opt["b2"],
                      eps=opt["eps"], weight_decay=opt["weight_decay"])
        self.step_fn = offload(build_train_step(self.model, adamw),
                               program_policy(self.traffic))
        self.opt_state = adamw.init(self.params)
        params0 = self.params
        self.readings = {"losses": [], "routing": [], "margins": []}
        for _ in range(self.traffic["check_steps"]):
            before, batch = self.params, self._tokens(self.steps)
            self.readings["losses"].append(self._step())
            routing = self.model.routing
            self.readings["routing"].append(routing)
            # The witness needs the parameters the step was handed,
            # which only set-up can hold without raising the peak.
            self.readings["margins"].append(
                ref.route_margin(before, batch, self.shape, self.config,
                                 routing)
                if self._covers(routing) else math.inf)
            del before
            if self.steps == 1:
                grad = ref_lm.tree_map(lambda m: m / (1 - opt["b1"]),
                                       self.opt_state["mu"])
                self.readings["grad1"] = ref_lm.leaf_norms(grad)
        self.readings["delta"] = ref_lm.leaf_norms(ref_lm.tree_map(
            lambda p, q: p - q, self.params, params0))

    def unit(self) -> None:
        counter = self.model.counter
        if self.window_from is None:
            self.window_from = (len(counter.routed), counter.host_ns)
        self.before_last = (self.params, self.opt_state["mu"], self.steps)
        self.last_loss = self._step()
        self.last_routing = self.model.routing
        self.window_steps += 1

    def end_to_end(self, wall_s: float) -> dict:
        tokens = self.window_steps * self.batch * self.seq
        return {"train_tokens_per_s": tokens / wall_s}

    def work(self) -> dict:
        """The window's work so far: model FLOPs, K1's bound and launches
        (the experts' products at the tokens the program routed), and
        the host time in the expert layers."""
        counter = self.model.counter
        start, host0 = self.window_from or (len(counter.routed),
                                            counter.host_ns)
        routed = counter.routed[start:]
        gemms = lm_work.emulated(
            moe_work.train_gemms(self.shape, self.batch, self.seq, routed),
            self.traffic["min_dim"])
        s = split_gemm.splits_of(self.traffic["backend"])
        return {"train_model_flops": moe_work.train_flops(
                    self.shape, self.batch, self.seq, routed),
                "train_k1_bound_s": split_gemm.k1_bound_s(
                    lm_work.expand(gemms), s),
                "train_real_gemms": sum(gemms.values()),
                "moe_host_ns": counter.host_ns - host0,
                "train_steps": len(routed) // self.shape.layers}

    def release(self) -> None:
        """Read the last window step, keep the parameters and moments it
        was handed and free the rest of the program's state (the counter
        stays).  The moments before the step are the first held and the
        second worked back from the step's own (the gradient the step
        took, from the first moments before and after it): holding both
        through the window would raise the peak by a parameter tree."""
        params, mu, step = self.before_last
        opt = self.traffic["adamw"]
        b1, b2 = opt["b1"], opt["b2"]

        def nu_before(nu_after, mu_after, mu_before):
            grad = (mu_after.double() - b1 * mu_before.double()) / (1 - b1)
            return ((nu_after.double() - (1 - b2) * grad * grad) / b2
                    ).clamp_(min=0).to(nu_after.dtype)
        self.readings["last"] = {
            "loss": self.last_loss, "routing": self.last_routing,
            "grad": step_grad_norms(self.opt_state["mu"], mu, b1),
            "delta": ref_lm.leaf_norms(ref_lm.tree_map(
                lambda p, q: p - q, self.params, params))}
        nu = ref_lm.tree_map(nu_before, self.opt_state["nu"],
                             self.opt_state["mu"], mu)
        self.before_last = (params, (mu, nu, step + 1), step)
        del self.step_fn, self.params, self.opt_state, mu, nu
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def reference(self, tf32: bool = False, rows=None,
                  routing=None, witness: bool = False,
                  dtype=torch.float32) -> dict:
        """The plain reference's readings over the first steps (``tf32``:
        the lower-precision control; ``rows``: each loss over the first
        ``rows`` positions only, a planted fault; ``routing``: per step,
        the routing to follow, else its own; ``witness``: each step's
        routing margin from its own parameters; ``dtype``: the type the
        steps run in)."""
        params0 = inputs_moe.moe_params(self.shape, self.seed, self.device)
        batches = [self._tokens(i)
                   for i in range(self.traffic["check_steps"])]
        return ref.train(params0, batches, self.shape, self.config,
                         self.traffic["adamw"], tf32=tf32, rows=rows,
                         routing=routing, witness=witness, dtype=dtype)

    def reference_last(self, tf32: bool = False, rows=None,
                       dtype=torch.float32, own_routing: bool = False
                       ) -> dict:
        """The plain reference's loss, gradient and change norms at the
        window's last step, from the parameters and moments the
        program's step was handed, routed as the program routed that
        step (``own_routing``: by its own top-k)."""
        params, moments, step = self.before_last
        routing = None if own_routing else self.readings["last"]["routing"]
        if routing is not None and not self._covers(routing):
            raise ValueError("the program's routing of the window's last "
                             "step does not cover the batch")
        return ref.step(params, self._tokens(step), self.shape, self.config,
                        tf32=tf32, rows=rows, dtype=dtype, routing=routing,
                        moments=moments, opt=self.traffic["adamw"])

    def _covers(self, routing) -> bool:
        """Whether a step's routing sent each of the batch's tokens."""
        return all(r.shape[0] == self.batch * self.seq for r in routing)

    def compared(self, control: bool = False) -> dict:
        """The numbers compared (``control``: the TF32 reference's, put
        in the program's place, with its own routing; module
        docstring)."""
        prog = self.reference(tf32=True, witness=True) if control \
            else self.readings
        covered = all(map(self._covers, prog["routing"]))
        routing = prog["routing"] if covered else None
        narrow = self.reference(routing=routing)
        want = dict(narrow, delta=self.reference(
            routing=routing, dtype=torch.float64)["delta"])
        self.attempted = len(prog["losses"]) + self.window_steps
        self.numbers, self.detail = gaps(prog, want)
        self.detail["delta_median_gap_f32"] = \
            gaps(prog, narrow)[0]["delta_median_gap"]
        margins = prog["margins"]
        prog = self.reference_last(tf32=True, own_routing=True) if control \
            else self.readings["last"]
        params, moments, step = self.before_last
        covered = self._covers(prog["routing"])
        want = ref.step(params, self._tokens(step), self.shape, self.config,
                        dtype=torch.float64,
                        routing=prog["routing"] if covered else None,
                        moments=moments, opt=self.traffic["adamw"])
        median = statistics.median(want["delta"].values())
        self.numbers.update(
            route_margin=max(margins) if covered else math.inf,
            delta_last_median_gap=statistics.median(
                abs(prog["delta"][k] - v) / max(v, median)
                for k, v in want["delta"].items()))
        numbers, detail = last_gaps(prog, want)
        self.detail.update(
            numbers, **detail, route_margins=margins,
            route_last_margin=want["margin"] if covered else math.inf,
            last_step=step + 1, loss_last=want["loss"])
        return self.numbers

    def failed(self, limits: dict) -> int:
        """Numbers over their limits."""
        return sum(v > limits[k] for k, v in self.numbers.items())
