"""The port's expert model (``repro_torch.models.moe.MoEModel``) against
its plain reference (``tests/reference_torch_moe.py``) on the CPU, at
the ``mellum2_tiny`` preset's size with seeded weights.

Tolerances.  The program runs in float32 and the reference in float64,
so every gap is float32 rounding carried through four layers: the
largest seen over seeds 3-5 were 8.1e-8 (loss, relative), 5.7e-7
(logits, against the largest logit) and 1.4e-6 (a gradient leaf's
difference norm over its norm), natively and through the emulation at
s = 9 alike.  The bounds sit about 7-10x above those: 1e-6, 4e-6 and
1e-5.  A routing decision that turned on rounding would put one token's
expert output on the wrong expert and show far above them.
"""

import pytest
import torch

import reference_torch_moe as ref
from repro_torch.configs import get_config
from repro_torch.core import PrecisionPolicy, offload, site_report
from repro_torch.core.intercept import scan
from repro_torch.kernels import ops
from repro_torch.launch import train
from repro_torch.models import MoEModel
from repro_torch.models.lm import _rope_table
from repro_torch.models.moe import _yarn_table, attention_mask, yarn_inv_freq
from repro_torch.obs import trace
from repro_torch.train import AdamW, SyntheticText

LOSS_TOL, LOGITS_TOL, GRAD_TOL = 1e-6, 4e-6, 1e-5
EMULATED = PrecisionPolicy(backend="pallas_int8_9", min_dim=8,
                           default_splits=9)


def ref_config(cfg) -> dict:
    """The reference's dict of published keys for an ``LMConfig``."""
    kinds = {"full": "full_attention", "sliding": "sliding_attention"}
    plain = {"rope_type": "default", "rope_theta": cfg.rope_theta}
    full = plain if not cfg.yarn_factor else {
        "rope_type": "yarn", "rope_theta": cfg.rope_theta,
        "factor": cfg.yarn_factor,
        "original_max_position_embeddings": cfg.yarn_original_max_positions,
        "beta_fast": cfg.yarn_beta_fast, "beta_slow": cfg.yarn_beta_slow,
        "attention_factor": cfg.yarn_attention_factor}
    return dict(
        num_hidden_layers=cfg.num_layers, num_attention_heads=cfg.num_heads,
        num_key_value_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
        rms_norm_eps=cfg.norm_eps,
        layer_types=[kinds[cfg.layer_kind(i)] for i in range(cfg.num_layers)],
        sliding_window=cfg.sliding_window,
        rope_parameters={"full_attention": full, "sliding_attention": plain},
        held_experts=list(cfg.held_experts),
        num_experts_per_tok=cfg.num_experts_per_tok,
        norm_topk_prob=cfg.norm_topk_prob,
        tie_word_embeddings=cfg.tie_embeddings)


def _double(tree):
    if isinstance(tree, dict):
        return {k: _double(v) for k, v in tree.items()}
    return tree.double()


def _leaves(tree, prefix=""):
    for key in sorted(tree):
        val = tree[key]
        if isinstance(val, dict):
            yield from _leaves(val, f"{prefix}{key}.")
        else:
            yield prefix + key, val


def _rel(a, b) -> float:
    return float((a.double() - b).norm() / b.norm())


@pytest.fixture(scope="module")
def tiny():
    cfg = get_config("mellum2_tiny")
    model = MoEModel(cfg, device="cpu", seed=3)
    batch = torch.as_tensor(SyntheticText(cfg.vocab_size, 32, 2,
                                          seed=5).batch(0))
    params = _double(model.params)
    want_loss, want_grads = ref.loss_and_grads(params, batch, ref_config(cfg))
    want_logits = ref.logits(params, batch[:, :-1], ref_config(cfg))
    return model, batch, want_loss, want_grads, want_logits


@pytest.mark.parametrize("emulated", [False, True],
                         ids=["native", "offload_s9"])
def test_program_matches_reference(tiny, emulated):
    """Loss, logits and every gradient leaf, natively and with every
    product of 8 or more rows through the emulation at s = 9."""
    model, batch, want_loss, want_grads, want_logits = tiny

    def wrap(fn):
        return offload(fn, EMULATED) if emulated else fn

    loss, grads = wrap(lambda p, b: train.loss_and_grads(model, p, b))(
        model.params, batch)
    logits = wrap(model.apply)(model.params, batch[:, :-1])
    assert abs(float(loss) - float(want_loss)) <= LOSS_TOL * float(want_loss)
    assert float((logits.double() - want_logits).abs().max()) <= \
        LOGITS_TOL * float(want_logits.abs().max())
    got = dict(_leaves(grads))
    want = dict(_leaves(want_grads))
    assert set(got) == set(want)
    for name, g in want.items():
        for layer in range(g.shape[0] if name.startswith("blocks.") else 1):
            a, b = (got[name][layer], g[layer]) if name.startswith(
                "blocks.") else (got[name], g)
            assert _rel(a, b) <= GRAD_TOL, (name, layer, _rel(a, b))


def test_offload_emulates_the_experts_and_attention(tiny):
    """The comparison above goes through the emulation: the held
    experts' products and the attention einsums are offloaded sites."""
    model, batch = tiny[:2]
    sites = site_report(lambda p, b: train.loss_and_grads(model, p, b),
                        EMULATED)(model.params, batch)
    on = [s for s in sites if s.offloaded]
    assert any(s.batch == 2 * model.cfg.num_heads for s in on)
    expert = [s for s in on if s.name.startswith("scan0/")
              and s.k == model.cfg.moe_d_ff]
    assert expert


@pytest.mark.parametrize("shape", [(16, 500000.0, 16.0, 32),
                                   (128, 500000.0, 16.0, 8192)],
                         ids=["tiny", "mellum2"])
def test_yarn_table_matches_reference(shape):
    head_dim, theta, factor, orig = shape
    rope = {"rope_type": "yarn", "rope_theta": theta, "factor": factor,
            "original_max_position_embeddings": orig, "beta_fast": 32.0,
            "beta_slow": 1.0, "attention_factor": 1.2772588722239782}
    freq = yarn_inv_freq(head_dim, theta, factor, orig, 32.0, 1.0)
    want, scaling = ref.inv_freq(rope, head_dim)
    assert torch.equal(freq, want)
    assert scaling == 1.2772588722239782
    cfg = get_config("mellum2_tiny").replace(
        head_dim=head_dim, rope_theta=theta, yarn_factor=factor,
        yarn_original_max_positions=orig)
    cos, sin = _yarn_table(300, cfg, "cpu")
    rcos, rsin = ref.rope_table(rope, head_dim, 300, "cpu")
    half = head_dim // 2
    assert torch.equal(cos[:300], rcos[:, :half])
    assert torch.equal(sin[:300], rsin[:, half:])
    # The sliding layers' plain table is the dense model's (theta ** (-j
    # / half) by powf, where the reference takes 1 / theta ** (2j / d)):
    # the two float32 frequencies part by an ulp or two, which position p
    # turns into an angle gap of up to 4 p 2^-23 (1.4e-4 at p = 300).
    plain = _rope_table(300, head_dim, theta, "cpu")
    pcos, psin = ref.rope_table({"rope_type": "default", "rope_theta": theta},
                                head_dim, 300, "cpu")
    assert torch.allclose(plain[0][:300], pcos[:, :half], atol=2e-4, rtol=0)
    assert torch.allclose(plain[1][:300], psin[:, :half], atol=2e-4, rtol=0)


def test_yarn_ramp_at_mellum2_widths():
    """Dimensions up to the correction range's start keep their
    frequency, those from its end on are divided by the factor, and the
    ramp runs between (start 18, end 35 at head_dim 128, theta 5e5, 8192
    original positions)."""
    freq = yarn_inv_freq(128, 500000.0, 16.0, 8192, 32.0, 1.0)
    base = 1.0 / 500000.0 ** (torch.arange(0, 128, 2).float() / 128)
    assert torch.allclose(freq[:19], base[:19], rtol=1e-6)
    assert torch.allclose(freq[35:], base[35:] / 16, rtol=1e-6)
    assert ((freq[19:35] < base[19:35]) & (freq[19:35] > base[19:35] / 16)
            ).all()


@pytest.mark.parametrize("kind", ["sliding", "full"])
def test_window_mask_matches_reference(kind):
    pos = torch.arange(20)
    got = attention_mask(kind, pos, pos, 8)
    want = ref.keep_mask(f"{kind}_attention", 20, 8, "cpu")
    assert torch.equal(got, want)
    assert int(got.sum(-1).max()) == (8 if kind == "sliding" else 20)


def _layer(lp, i):
    return {k: v[i] for k, v in lp.items()}


def _sliced(model, experts):
    """A copy of ``model`` holding only ``experts``, with their weights."""
    cfg = model.cfg.replace(experts_held=tuple(experts))
    part = MoEModel(cfg, device="cpu", seed=0)
    pick = [model.cfg.held_experts.index(e) for e in experts]
    params = model.params
    blocks = {k: (v[:, pick] if k in ("w_gate", "w_up", "w_down") else v)
              for k, v in params["blocks"].items()}
    return part, dict(params, blocks=blocks)


def test_expert_shares_sum_to_the_uncut_layer():
    """Eight ranks, each holding a different eighth of the 16 experts:
    the sum of their expert outputs is the uncut layer's, and the
    reference's."""
    cfg = get_config("mellum2_tiny").replace(experts_held=())
    whole = MoEModel(cfg, device="cpu", seed=11)
    x = torch.randn(2, 24, cfg.d_model, generator=torch.Generator()
                    .manual_seed(2))
    total = torch.zeros_like(x)
    for rank in range(8):
        part, params = _sliced(whole, range(2 * rank, 2 * rank + 2))
        total += part._experts(_layer(params["blocks"], 1), x) - x
    uncut = whole._experts(_layer(whole.params["blocks"], 1), x) - x
    assert torch.allclose(total, uncut, atol=1e-6, rtol=0)
    blk = _double(whole.params["blocks"])
    h = ref.rms_norm(x.double(), blk["mlp_norm"][1], cfg.norm_eps)
    want = ref.experts(h.reshape(-1, cfg.d_model), blk, 1, ref_config(cfg))
    assert torch.allclose(uncut.double().reshape(-1, cfg.d_model), want,
                          atol=1e-5, rtol=0)


_EXPERT_KEYS = ("mlp_norm", "router", "w_gate", "w_up", "w_down")


def _steered(model, groups, routes):
    """Inputs whose tokens route as told: token group ``g`` (its size in
    ``groups``) is one basis direction, and the router sends it to the
    experts in ``routes[g]`` (as many as the top-k)."""
    cfg = model.cfg
    x = torch.cat([torch.eye(cfg.d_model)[g].expand(n, -1)
                   for g, n in enumerate(groups)])[None]
    router = torch.full((cfg.d_model, cfg.num_experts), -1.0)
    for g, experts in enumerate(routes):
        router[g, list(experts)] = 1.0
    lp = _layer(model.params["blocks"], 0)
    return dict({k: lp[k] for k in _EXPERT_KEYS}, router=router), x


def _grad_fn(model):
    def fn(lp, x):
        leaves = {k: v.detach().requires_grad_() for k, v in lp.items()}
        with torch.enable_grad():
            out = model._experts(leaves, x)
            return torch.autograd.grad(out.square().sum(),
                                       list(leaves.values()))
    return fn


#: min_dim 24 lies between the 10 tokens of group 0 and the 40 of both
#: groups, and above the router's 16 outputs (the router stays native).
GATE = PrecisionPolicy(backend="pallas_int8_6", min_dim=24,
                       default_splits=6)
SCENARIOS = {"every_expert_routed": [(0, 1, 2, 3), (0, 1, 2, 3)],
             "expert0_no_tokens": [(1, 2, 3, 4), (1, 2, 3, 4)],
             "expert1_under_min_dim": [(0, 1, 2, 3), (0, 2, 3, 4)]}


def test_site_names_stable_under_routing():
    """Every held expert makes its products whatever it is routed: with
    no tokens, or with fewer than ``min_dim``, the sites keep their
    names and only their decisions change."""
    model = MoEModel(get_config("mellum2_tiny"), device="cpu", seed=1)
    seen = {}
    for name, routes in SCENARIOS.items():
        lp, x = _steered(model, (10, 30), routes)
        sites = site_report(_grad_fn(model), GATE)(lp, x)
        seen[name] = {s.name: s for s in sites}
    names = [list(found) for found in seen.values()]
    assert names[0] == names[1] == names[2]
    expert0, expert1 = ["dot1", "dot2", "dot3"], ["dot4", "dot5", "dot6"]
    assert all(seen["every_expert_routed"][n].offloaded
               for n in expert0 + expert1)
    assert not any(seen["expert0_no_tokens"][n].offloaded for n in expert0)
    assert seen["expert0_no_tokens"]["dot1"].m == 0
    assert not any(seen["expert1_under_min_dim"][n].offloaded
                   for n in expert1)
    assert all(seen["expert1_under_min_dim"][n].offloaded for n in expert0)


def test_counter_and_launches_in_a_ragged_scan(monkeypatch):
    """Two layers in one scan share their site names but route
    differently: each run of a product, forward and cotangent, is
    decided on its own rows.  The counter's routed tokens, under the
    gate, give the K1 launches (counted on the CPU, where the kernel runs
    its plain version), and the gradient agrees with native's."""
    model = MoEModel(get_config("mellum2_tiny"), device="cpu", seed=1)
    layers = [_steered(model, (10, 30), SCENARIOS[name])
              for name in ("expert1_under_min_dim", "every_expert_routed")]
    stacked = {k: torch.stack([lp[k] for lp, _ in layers])
               for k in layers[0][0]}
    x = layers[0][1]

    def fn(lp_all, x):
        leaves = {k: v.detach().requires_grad_() for k, v in lp_all.items()}
        with torch.enable_grad():
            out, _ = scan(lambda h, lp: (model._experts(lp, h), None), x,
                          leaves)
            return torch.autograd.grad(out.square().sum(),
                                       list(leaves.values()))

    plain = ops.split_gemm_kmajor_plain

    def counted(*args, **kwargs):
        ops.LAUNCHES["split_gemm"] += 1
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "split_gemm_kmajor_plain", counted)
    before = ops.LAUNCHES["split_gemm"]
    got = offload(fn, GATE)(stacked, x)
    launches = ops.LAUNCHES["split_gemm"] - before
    routed = model.counter.routed
    assert routed == [(40, 10, 40, 40), (40, 40, 40, 40)]
    emulated = sum(m >= GATE.min_dim for call in routed for m in call)
    assert launches == 3 * 3 * emulated == 63
    want = fn(stacked, x)
    for a, b in zip(got, want):
        assert torch.allclose(a, b, atol=1e-5, rtol=1e-5)


def test_routed_counter_equals_the_routing():
    """The counter's tokens per held expert, and the model's kept
    routing, equal the reference routing's own on the same rows."""
    cfg = get_config("mellum2_tiny")
    model = MoEModel(cfg, device="cpu", seed=4)
    x = torch.randn(2, 40, cfg.d_model, generator=torch.Generator()
                    .manual_seed(9))
    lp = _layer(model.params["blocks"], 2)
    model._experts(lp, x)
    h = ref.rms_norm(x, lp["mlp_norm"], cfg.norm_eps).reshape(-1, cfg.d_model)
    _, chosen = ref.routing(h, lp["router"], ref_config(cfg))
    want = tuple(int((chosen == e).sum()) for e in cfg.held_experts)
    assert model.counter.routed == [want]
    # The model keeps the choice itself too (the benchmark's reference
    # follows it).
    assert torch.equal(model.routing[-1].sort(-1).values,
                       chosen.sort(-1).values)
    assert model.counter.host_ns > 0


def _inside(child, parent) -> bool:
    return (child["tid"] == parent["tid"] and parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


def test_expert_spans_nest_in_the_forward():
    """A train step under an active tracer: one ``moe.route`` and one
    ``moe.experts`` a layer, each inside ``train.forward`` (autograd
    runs the cotangents with no expert-layer code, so the backward holds
    none), and the held experts' offloaded products inside
    ``moe.experts``."""
    cfg = get_config("mellum2_tiny")
    model = MoEModel(cfg, device="cpu", seed=2)
    opt = AdamW(lr=3e-3)
    step = offload(train.build_train_step(model, opt), EMULATED)
    data = SyntheticText(cfg.vocab_size, 32, 2, seed=1)
    params, state = model.params, opt.init(model.params)
    step(params, state, torch.as_tensor(data.batch(0)))
    tracer = trace.Tracer()
    with trace.activate(tracer):
        for i in range(2):
            params, state, _ = step(params, state,
                                    torch.as_tensor(data.batch(i)))
    spans = tracer.events
    forward = [s for s in spans if s["name"] == "train.forward"]
    backward = [s for s in spans if s["name"] == "train.backward"]
    for name in ("moe.route", "moe.experts"):
        found = [s for s in spans if s["name"] == name]
        assert len(found) == 2 * cfg.num_layers
        assert all(sum(_inside(s, f) for f in forward) == 1 for s in found)
        assert not any(_inside(s, b) for s in found for b in backward)
    experts = [s for s in spans if s["name"] == "moe.experts"]
    sites = [s for s in spans if s["name"] == "offload.site"]
    in_experts = [s for s in sites if any(_inside(s, e) for e in experts)]
    routed = model.counter.routed[-2 * cfg.num_layers:]
    assert len(in_experts) == 3 * sum(
        m >= EMULATED.min_dim for call in routed for m in call)


def test_every_product_is_finished_in_k1s_epilogue(monkeypatch):
    """A train step's ``ozaki_matmul`` calls, forward and cotangent, all
    take float32 products: each counts as "epilogue" in ``ops.COMBINES``
    and is one K1 (its plain version here), and none runs the torch
    combine.  A fused (K2) call does."""
    cfg = get_config("mellum2_tiny")
    model = MoEModel(cfg, device="cpu", seed=2)
    opt = AdamW(lr=3e-3)
    step = offload(train.build_train_step(model, opt), EMULATED)
    data = SyntheticText(cfg.vocab_size, 32, 2, seed=1)
    k1 = []
    plain = ops.split_gemm_kmajor_plain

    def counted(*args, **kwargs):
        k1.append(1)
        return plain(*args, **kwargs)

    monkeypatch.setattr(ops, "split_gemm_kmajor_plain", counted)
    before = dict(ops.COMBINES)
    step(model.params, opt.init(model.params),
         torch.as_tensor(data.batch(0)))
    assert len(k1) > 3 * cfg.num_layers
    assert ops.COMBINES == {"epilogue": before["epilogue"] + len(k1),
                            "torch": before["torch"]}
    x = torch.randn(16, cfg.d_model)
    ops.ozaki_matmul(x, x.T, 6, fuse_slicing=True)
    assert ops.COMBINES == {"epilogue": before["epilogue"] + len(k1),
                            "torch": before["torch"] + 1}


def test_launch_train_runs_the_cpu_preset(tmp_path):
    report = {}
    losses = train.main(
        ["--arch", "mellum2_tiny", "--steps", "2", "--seq-len", "32",
         "--global-batch", "2", "--backend", "pallas_int8_6",
         "--min-dim", "16", "--metrics-dir", "none",
         "--ckpt-dir", str(tmp_path / "ckpt")], device="cpu", report=report)
    assert len(losses) == 2 and all(torch.isfinite(torch.tensor(losses)))
    names = {s.name for s in report["sites"] if s.offloaded}
    assert "scan0/dot1" in names and "scan0/dot3" in names
    assert (tmp_path / "ckpt").exists()
