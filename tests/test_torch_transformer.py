"""The port's decoder-only transformer (``repro_torch.models.transformer``),
its five LM configs and its serving loop (``launch/serve_lm.py``) against
the JAX package on the same numpy inputs, on the CPU, at each arch's
``SMOKE`` config (2 layers, d <= 128), B <= 2, S <= 16.

The reference's parameters come from its own ``init_params`` and cross
over through ``carry.model_from``; its caches through ``carry.cache_from``.
The reference's functions are compiled with XLA's excess precision off
(``strict``), which makes every bf16 op round on its own, as it does
when the reference runs eagerly (``tests/test_arch_smoke.py``): the two
are equal bit for bit (``test_strict_reference_equals_its_eager_run``),
and the compiled one takes ~1 s where eager dispatch compiles ~160 ops
one by one (~10 s an arch). With excess precision allowed, XLA keeps
fused bf16 intermediates in float32 and the reference differs from its
own eager run by up to 12% of the largest logit at these sizes.
Tolerances:

* float32 compute: rtol = atol = 2e-4, ``test_arch_smoke.py``'s;
* bf16 compute (the configs' own): max |port - reference| <= 2^-6 x
  max |reference|, four bf16 ulps (2^-8 relative) at the largest value.
  The activations and every elementwise op round as the reference's do,
  so most outputs are equal bit for bit; where they are not, a float32
  ``exp`` (XLA's and torch's differ in the last bit now and then) moved
  the bf16 rounding of an attention probability by one ulp, which the
  later layers carry. The largest error measured: 1.43 ulps (0.0056 x
  the largest logit, qwen2-7b);
* the routing plan, spec trees, configs and padded logit columns: equal.
"""
import dataclasses
import functools
import json
import math
import types

import numpy as np
import pytest
from torch_threads import one_thread  # noqa: F401

jax = pytest.importorskip("jax")
torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from repro import configs as ref_configs  # noqa: E402
from repro.dist.sharding import NULL_CTX as REF_NULL_CTX  # noqa: E402
from repro.models import common as ref_common  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402
from repro_torch import carry  # noqa: E402
from repro_torch.dist.sharding import NULL_CTX  # noqa: E402
from repro_torch.launch import serve_lm  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

CPU = "cpu"
ARCHS = list(carry.LM_ARCHS)
DENSE = ARCHS[:3]
MOE = ARCHS[3:]
DTYPES = ["float32", "bfloat16"]
F32_TOL = 2e-4
BF16_TOL = 2.0 ** -6       # of the largest |value|
REF_ENTRIES = ref_configs.load_all()


# XLA's optimisation level 0 compiles in a third of the time; the
# reference's outputs are the same bits
FAST_COMPILE = {"xla_backend_optimization_level": 0}


def strict(fn, *args):
    """``fn`` compiled for ``args``' shapes with every bf16 op rounded on
    its own (``xla_allow_excess_precision`` off); call it with arrays of
    those shapes."""
    return jax.jit(fn).lower(*args).compile(
        dict(FAST_COMPILE, xla_allow_excess_precision=False))


def ref_run(fn, *args):
    return strict(fn, *args)(*args)


def as_np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def close(got, want, dtype, what="", scaled=False):
    """Within the float32 or the bf16 tolerance (module docstring);
    ``scaled`` takes float32's atol as a share of max |want|. Returns the
    largest absolute difference."""
    got, want = as_np(got), as_np(want)
    assert got.shape == want.shape, what
    err = float(np.abs(got - want).max()) if got.size else 0.0
    if dtype == "float32":
        atol = F32_TOL * (float(np.abs(want).max()) if scaled else 1.0)
        np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=atol,
                                   err_msg=what)
    else:
        assert err <= BF16_TOL * float(np.abs(want).max()), \
            f"{what}: {err} beyond 2^-6 x {float(np.abs(want).max())}"
    return err


def smoke(arch, dtype="bfloat16", **kw):
    cfg = REF_ENTRIES[arch].smoke_config
    return dataclasses.replace(cfg, compute_dtype=getattr(jnp, dtype), **kw)


def carry_params(arch, cfg, seed=0):
    specs = ref_T.build_specs(cfg)
    key = jax.random.key(seed)
    ref = jax.jit(lambda k: ref_common.init_params(specs, k)).lower(
        key).compile(FAST_COMPILE)(key)
    arrays = jax.tree_util.tree_map(np.asarray, ref)
    params, pcfg = carry.model_from(arch, arrays, dataclasses.asdict(cfg),
                                    device=CPU)
    return ref, params, pcfg


@functools.lru_cache(maxsize=None)
def _params(arch):
    return carry_params(arch, REF_ENTRIES[arch].smoke_config)


def model(arch, dtype):
    """(cfg, reference params, port params, port cfg) at ``dtype``
    compute; the parameters (in their spec dtypes) serve both."""
    cfg = smoke(arch, dtype)
    ref, params, _ = _params(arch)
    return cfg, ref, params, carry.config_of(arch, dataclasses.asdict(cfg))


def tokens(cfg, B=2, S=16, seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, S)).astype(np.int32)


def torch_ids(a):
    return torch.tensor(np.asarray(a), dtype=torch.int64)


# ---------------------------------------------------------------------------
# prefill
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_and_loss_match_reference(arch, dtype):
    cfg, ref, params, pcfg = model(arch, dtype)
    toks = tokens(cfg)
    (want, want_aux), want_loss = ref_run(
        lambda p, t: (ref_T.forward(p, t, cfg),
                      ref_T.loss_fn(p, {"tokens": t}, cfg)),
        ref, jnp.asarray(toks))
    got, aux = T.forward(params, torch_ids(toks), pcfg)
    assert got.dtype == carry.torch_dtype(cfg.compute_dtype)
    assert tuple(got.shape) == (2, 16, cfg.vocab_pad)
    close(got, want, dtype, "logits")
    close(aux, want_aux, "float32", "aux")
    close(T.loss_fn(params, {"tokens": torch_ids(toks)}, pcfg), want_loss,
          dtype, "loss")


def test_strict_reference_equals_its_eager_run():
    """The compiled reference (its scan over layers) with excess precision
    off gives the bf16 logits of its eager, unrolled run bit for bit."""
    cfg, ref, _, _ = model("gemma-2b", "bfloat16")
    assert cfg.scan_layers
    toks = jnp.asarray(tokens(cfg, S=8))
    eager, _ = ref_T.forward(ref, toks,
                             dataclasses.replace(cfg, scan_layers=False))
    compiled, _ = ref_run(lambda p, t: ref_T.forward(p, t, cfg), ref, toks)
    np.testing.assert_array_equal(as_np(compiled), as_np(eager))


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ["granite-moe-1b-a400m", "gemma-2b"])
def test_padded_vocab_columns_and_softcap_match_reference(arch, dtype):
    """vocab 500 pads to 512: the padded columns carry -1e30 rounded to
    the logits' dtype, equal in both packages; a soft cap of 30 meets
    the logits as a weakly typed scalar."""
    cfg = smoke(arch, dtype, vocab=500, logit_softcap=30.0)
    ref, params, pcfg = carry_params(arch, cfg, seed=3)
    toks = tokens(cfg, S=8, seed=4)
    want, _ = ref_run(lambda p, t: ref_T.forward(p, t, cfg), ref,
                      jnp.asarray(toks))
    got, _ = T.forward(params, torch_ids(toks), pcfg)
    close(got[..., :500], want[..., :500], dtype, "logits")
    np.testing.assert_array_equal(as_np(got[..., 500:]),
                                  as_np(want[..., 500:]))
    assert float(got[..., 500:].max()) < -9e29
    cache = {k: torch.zeros(s.shape, dtype=s.dtype)
             for k, s in T.cache_specs(pcfg, 2, 4).items()}
    lg, _ = T.decode_step(params, cache, torch_ids(toks[:, 0]),
                          torch.zeros(2, dtype=torch.int64), pcfg)
    np.testing.assert_array_equal(as_np(lg[:, 500:]),
                                  as_np(want[:, 0, 500:]))


def test_scalar_meets_bf16_as_a_weak_type():
    """``embed.astype(bf16)[tokens] * sqrt(2048)``: JAX rounds the scalar
    to bf16 (45.25) first; torch would multiply by 45.2548... and round
    once, which differs in some thousands of 100,000 values."""
    x = np.random.default_rng(5).standard_normal(100_000).astype(np.float32)
    jx = jnp.asarray(x).astype(jnp.bfloat16)
    tx = torch.from_numpy(x).to(torch.bfloat16)
    c = math.sqrt(2048)
    want = as_np(jx * c)
    np.testing.assert_array_equal(as_np(tx * T.weak(tx, c)), want)
    assert (as_np(tx * c) != want).sum() > 1000
    assert float(T.weak(tx, c)) == 45.25
    cfg = dataclasses.replace(REF_ENTRIES["qwen2-7b"].config, n_layers=0,
                              d_model=2048)
    emb = np.random.default_rng(6).standard_normal((256, 2048)).astype(
        np.float32)
    toks = np.arange(256)
    got = T._embed({"embed": torch.from_numpy(emb)}, torch_ids(toks),
                   carry.config_of("qwen2-7b", dataclasses.asdict(cfg)))
    np.testing.assert_array_equal(
        as_np(got), as_np(jnp.asarray(emb).astype(jnp.bfloat16)[toks] * c))


@pytest.mark.parametrize("name", ["silu", "gelu_tanh"])
def test_activations_round_op_by_op_as_the_reference(name):
    x = (np.random.default_rng(7).standard_normal(50_000) * 4).astype(
        np.float32)
    for dt, tdt in ((jnp.bfloat16, torch.bfloat16),
                    (jnp.float32, torch.float32)):
        want = ref_common.act_fn(name)(jnp.asarray(x).astype(dt))
        got = T.act(name)(torch.from_numpy(x).to(tdt))
        if dt == jnp.bfloat16:
            np.testing.assert_array_equal(as_np(got), as_np(want))
        else:
            np.testing.assert_allclose(as_np(got), as_np(want), rtol=1e-6,
                                       atol=1e-6)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("S,kv_block", [(2048, 1024), (24, 16), (12, 1024)])
def test_blockwise_attention_matches_reference(S, kv_block, dtype):
    """kv_block 1024 over S = 2048 (two blocks), 16 over S = 24 (halved
    to 8: three blocks), and one block of 12."""
    rng = np.random.default_rng(S)
    B, H, Hkv, hd = 1, 4, 2, 16
    q, k, v = (rng.standard_normal((B, S, h, hd)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    pos = np.broadcast_to(np.arange(S), (B, S))
    cfg = smoke("qwen2-7b", dtype)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    want = ref_run(
        lambda q_, k_, v_, p_: ref_T._blockwise_self_attention(
            q_, k_, v_, p_, cfg, REF_NULL_CTX, kv_block=kv_block),
        *(jnp.asarray(a).astype(jd) for a in (q, k, v)), jnp.asarray(pos))
    got = T._blockwise_self_attention(
        *(torch.from_numpy(a).to(td) for a in (q, k, v)), torch_ids(pos),
        carry.config_of("qwen2-7b", dataclasses.asdict(cfg)), NULL_CTX,
        kv_block=kv_block)
    assert got.dtype == td
    close(got, want, dtype, f"S={S}")


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------

def reference_group_plan(Tg, k, cap, E):
    """The reference's own ``group_plan`` (nested in ``moe_ffn``), rebuilt
    from its code object over the closure values ``moe_ffn`` gives it."""
    code = next(c for c in ref_T.moe_ffn.__code__.co_consts
                if getattr(c, "co_name", None) == "group_plan")
    env = {"Tg": Tg, "k": k, "cap": cap, "E": E,
           "tokid": jnp.arange(Tg * k, dtype=jnp.int32) // k}
    cells = tuple(types.CellType(env[n]) for n in code.co_freevars)
    return types.FunctionType(code, vars(ref_T), "group_plan", None, cells)


@pytest.mark.parametrize("G,Tg,k,E,cap", [
    (1, 16, 2, 4, 2),      # skewed ids: every expert over capacity
    (1, 24, 8, 32, 7),     # granite's top-8 of 32 at its own cap
    (3, 8, 2, 8, 1),       # cap 1: most choices dropped, three groups
    (2, 10, 2, 4, 40),     # nothing dropped
])
def test_routing_plan_equals_reference(G, Tg, k, E, cap):
    rng = np.random.default_rng(G * 100 + Tg)
    p = rng.dirichlet(np.ones(E) * 0.3)
    eid = np.stack([np.stack([rng.choice(E, k, replace=False, p=p)
                              for _ in range(Tg)]).reshape(-1)
                    for _ in range(G)]).astype(np.int32)
    plan = strict(reference_group_plan(Tg, k, cap, E), jnp.asarray(eid[0]))
    src_tok, slot_of = T.routing_plan(torch_ids(eid), cap, E, k)
    for g in range(G):
        want_src, want_slot = plan(jnp.asarray(eid[g]))
        np.testing.assert_array_equal(src_tok[g].numpy(),
                                      np.asarray(want_src))
        np.testing.assert_array_equal(slot_of[g].numpy(),
                                      np.asarray(want_slot))
    if cap < Tg * k // E:
        assert (slot_of == E * cap).any()      # the cut dropped some


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_reference(arch, dtype):
    """On a layer's own input scale (unit RMS). The experts' fan-in is
    the expert count (the reference's init takes a leaf's first axis),
    so outputs reach ~10^3 and float32 sums in another order leave ~1e-4
    on outputs that cancel to near zero: float32's atol is 2e-4 of the
    largest output."""
    cfg, ref, params, pcfg = model(arch, dtype)
    x = np.random.default_rng(8).standard_normal(
        (24, cfg.d_model)).astype(np.float32)
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    lp_ref = jax.tree_util.tree_map(lambda a: a[1], ref["layers"])
    want, want_aux = ref_run(
        lambda lp, x_: ref_T.moe_ffn(lp, x_, cfg, REF_NULL_CTX), lp_ref,
        jnp.asarray(x).astype(jd))
    got, aux = T.moe_ffn(T._layer(params, 1), torch.from_numpy(x).to(td),
                         pcfg, NULL_CTX)
    assert got.dtype == td
    close(got, want, dtype, "moe_ffn", scaled=True)
    close(aux, want_aux, "float32", "aux")


def test_expert_matmul_casts_a_few_experts_at_a_time(monkeypatch):
    """A weight in another dtype is cast in slices of experts; the
    product is the whole cast's."""
    rng = np.random.default_rng(9)
    a = torch.from_numpy(rng.standard_normal((6, 5, 8)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((6, 8, 3)).astype(
        np.float32)).to(torch.bfloat16)
    whole = torch.matmul(a, w.float())
    monkeypatch.setattr(T, "CAST_CHUNK_BYTES", 2 * 8 * 3 * 4)
    assert torch.equal(T._expert_matmul(a, w, torch.float32), whole)
    assert T._expert_matmul(a.bfloat16(), w, torch.bfloat16).dtype == \
        torch.bfloat16


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------

def zeros_cache(cfg, B, max_len):
    return {k: torch.zeros(s.shape, dtype=s.dtype)
            for k, s in T.cache_specs(cfg, B, max_len).items()}


def ref_zeros_cache(cfg, B, max_len):
    return {k: jnp.zeros(s.shape, s.dtype)
            for k, s in ref_T.cache_specs(cfg, B, max_len).items()}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", ARCHS)
def test_decode_matches_reference_and_resumes_on_its_cache(arch, dtype):
    """Six steps from an empty cache: logits and caches against the
    reference's at every step. Then the port resumes at step 3 from the
    reference's cache, carried by ``carry.cache_from``."""
    cfg, ref, params, pcfg = model(arch, dtype)
    B, max_len, steps = 2, 8, 6
    toks = tokens(cfg, B=B, S=steps, seed=2)
    rcache, cache = ref_zeros_cache(cfg, B, max_len), \
        zeros_cache(pcfg, B, max_len)
    ref_logits, ref_caches = [], []
    step = strict(lambda p, c, t, ln: ref_T.decode_step(p, c, t, ln, cfg),
                  ref, rcache, jnp.asarray(toks[:, 0]),
                  jnp.zeros((B,), jnp.int32))
    for t in range(steps):
        lens = np.full((B,), t, np.int32)
        want, rcache = step(ref, rcache, jnp.asarray(toks[:, t]),
                            jnp.asarray(lens))
        got, out = T.decode_step(params, cache, torch_ids(toks[:, t]),
                                 torch_ids(lens), pcfg)
        assert out is cache and got.shape == (B, cfg.vocab_pad)
        close(got, want, dtype, f"step {t} logits")
        for n in ("k", "v"):
            close(cache[n], rcache[n], dtype, f"step {t} cache {n}")
        ref_logits.append(want)
        ref_caches.append(jax.tree_util.tree_map(np.asarray, rcache))
    resumed = carry.cache_from(ref_caches[2], device=CPU)
    assert resumed["k"].dtype == carry.torch_dtype(cfg.compute_dtype)
    for t in range(3, steps):
        got, _ = T.decode_step(params, resumed, torch_ids(toks[:, t]),
                               torch.full((B,), t, dtype=torch.int64), pcfg)
        close(got, ref_logits[t], dtype, f"resumed step {t}")
    for n in ("k", "v"):
        close(resumed[n], ref_caches[-1][n], dtype, f"resumed cache {n}")


@pytest.mark.parametrize("arch", DENSE)
def test_decode_equals_forward_for_dense_archs(arch):
    """Step-by-step decode logits equal the teacher-forced forward's at
    float32 (the reference's invariant; MoE decode routes B tokens at a
    smaller capacity than the prefill's, so it holds for dense archs
    only). ``scan_layers`` does not change a number."""
    cfg, _, params, pcfg = model(arch, "float32")
    toks = torch_ids(tokens(cfg, S=7, seed=3))
    full, _ = T.forward(params, toks, pcfg)
    scanned = dataclasses.replace(pcfg, scan_layers=True, remat=True)
    assert torch.equal(T.forward(params, toks, scanned)[0], full)
    cache, cache2 = zeros_cache(pcfg, 2, 8), zeros_cache(pcfg, 2, 8)
    for t in range(7):
        lens = torch.full((2,), t, dtype=torch.int64)
        lg, _ = T.decode_step(params, cache, toks[:, t], lens, pcfg)
        close(lg, full[:, t], "float32", f"position {t}")
        lg2, _ = T.decode_step(params, cache2, toks[:, t], lens, scanned)
        assert torch.equal(lg, lg2)


def test_decode_drops_a_write_past_the_cache():
    """A row whose ``cache_len`` is past the cache writes nothing (the
    reference's one-hot is all zeros there); the other row writes."""
    cfg, _, params, pcfg = model("qwen2-7b", "float32")
    cache = zeros_cache(pcfg, 2, 4)
    T.decode_step(params, cache, torch_ids([3, 4]), torch_ids([4, 1]), pcfg)
    written = cache["k"].abs().sum(dim=(0, 3, 4)) > 0       # (B, S_max)
    assert written.tolist() == [[False] * 4, [False, True, False, False]]


def test_cache_from_checks_its_arrays():
    k = np.zeros((2, 1, 4, 2, 8), np.float32)
    with pytest.raises(KeyError):
        carry.cache_from({"k": k}, device=CPU)
    with pytest.raises(ValueError):
        carry.cache_from({"k": k, "v": k[:, :, :2]}, device=CPU)
    bf = np.asarray(jnp.ones((2, 1, 4, 2, 8), jnp.bfloat16))
    out = carry.cache_from({"k": bf, "v": bf}, device=CPU)
    assert out["v"].dtype == torch.bfloat16 and bool((out["k"] == 1).all())


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------

def test_generate_equals_the_reference_loop():
    """``serve_lm.generate`` on carried parameters gives the ids of the
    reference's example loop (``examples/serve_lm.py``: a jitted
    ``decode_step`` fills the cache over the prompt, then greedy)."""
    cfg = dataclasses.replace(REF_ENTRIES["qwen2-7b"].smoke_config,
                              compute_dtype=jnp.float32)
    ref, params, pcfg = carry_params("qwen2-7b", cfg, seed=0)
    B, prompt_len, gen_len, max_len = 2, 5, 6, 16
    prompts = np.random.default_rng(0).integers(1, cfg.vocab,
                                                (B, prompt_len))
    decode = jax.jit(lambda p, c, t, ln: ref_T.decode_step(p, c, t, ln, cfg))
    cache = ref_zeros_cache(cfg, B, max_len)
    for t in range(prompt_len):
        logits, cache = decode(ref, cache, jnp.asarray(prompts[:, t],
                                                       jnp.int32),
                               jnp.full((B,), t, jnp.int32))
    out = []
    tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
    for t in range(prompt_len, prompt_len + gen_len):
        out.append(tok)
        logits, cache = decode(ref, cache, tok, jnp.full((B,), t, jnp.int32))
        tok = jnp.argmax(logits[:, :cfg.vocab], axis=-1).astype(jnp.int32)
    want = np.stack([np.asarray(t) for t in out], axis=1)
    got = serve_lm.generate(params, pcfg, torch_ids(prompts), gen_len,
                            max_len)
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        serve_lm.generate(params, pcfg, torch_ids(prompts), 12, max_len)


def test_serve_lm_cli_on_the_cpu(capsys):
    """The CLI's example loop on the smoke config, with its checks."""
    assert serve_lm.main(["--arch", "qwen2-7b", "--config", "smoke",
                          "--device", "cpu"]) == 0
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("generated 4x20 tokens") and "on cpu" in \
        lines[0]
    ids = [int(t) for t in lines[1].split(":", 1)[1].strip(" []").split(",")]
    assert len(ids) == 20 and all(0 <= i < 512 for i in ids)
    summary = json.loads(lines[-1])
    assert summary["ok"] and summary["device"] == "cpu"
    assert serve_lm.main(["--arch", "gemma-2b", "--device", "cpu",
                          "--batch", "2", "--prompt-len", "3",
                          "--gen-len", "4", "--max-len", "7"]) == 0
    with pytest.raises(SystemExit):
        serve_lm.main(["--device", "cpu", "--max-len", "31"])
