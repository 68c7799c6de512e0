"""Tensor-parallel replica groups of the port (distributed/
tensor_parallel.py and the models' split paths) against tp = 1 and the
JAX package, at every family's reduced config (fp32), on the CPU.

The reference's params come across through ``bridge.params_from_numpy``
and are placed on a ``(1, 2)`` group of ``["cpu", "cpu"]`` by
``shard_params`` (``param_specs``: heads, d_ff, vocab, Mamba2's
projections and, for MoE, the experts in mode ``"fsdp"`` or d_ff in
``"ep2d"``).  Tolerance: logits within 1e-5 of the largest |logit| (fp32;
a split sums its partial products in another order than one matmul),
greedy tokens equal.  Prefill (``lm_forward``, ``make_prefill`` under LBM
and LWM plans: flash attention on each shard's heads, the FFN kernels'
plain versions on each shard's d_ff slice), then a teacher-forced decode
epoch under each plan.  Also: the plan kernels see only shard shapes,
twice as often as at tp = 1; placement (pieces on the group's devices,
each head-split KV cache's pieces on theirs, everything else on its
first); an expert-split MoE decode runs each entry once, on the shard
that holds its expert; a group repeats bitwise; a shard refuses plain
torch ops; a tp = 2 server equals a tp = 1 server's traces and tokens,
and its serial loop its pipelined one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import plan as rplan
from repro.core.allocator import Selection as RSelection
from repro.core.mct import MappingCandidate as RCandidate
from repro.distributed import sharding as RSH
from repro.models import model as RM
from repro.models import transformer as RT
from repro.models.base import get_arch as ref_arch
from repro_torch import bridge
from repro_torch.core import plan as pplan
from repro_torch.core.allocator import Selection as PSelection
from repro_torch.core.mct import MappingCandidate as PCandidate
from repro_torch.distributed import sharding as PSH
from repro_torch.distributed import tensor_parallel as tp
from repro_torch.kernels import block_fused_ffn as kffn
from repro_torch.kernels import cache_matmul as kmm
from repro_torch.launch import mesh as PMesh
from repro_torch.launch import serve as PS
from repro_torch.models import model as PM
from repro_torch.models import moe as PMoE
from repro_torch.models import transformer as PT
from repro_torch.models.base import get_arch
from repro_torch.sim.driver import TenantSpec

REL = 1e-5          # of the largest |logit|
B, MAX_LEN, PROMPT = 2, 64, 16
CASES = [("yi-9b", None), ("mamba2-370m", None), ("olmoe-1b-7b", "fsdp"),
         ("olmoe-1b-7b", "ep2d"), ("zamba2-2.7b", None),
         ("whisper-tiny", None), ("llava-next-mistral-7b", None)]
IDS = [a if m is None else f"{a}-{m}" for a, m in CASES]
GROUP = PMesh.make_serving_mesh(1, tp=2, devices=["cpu", "cpu"])


@dataclasses.dataclass
class Case:
    rcfg: object
    pcfg: object
    rparams: object
    one: dict               # the port at tp = 1
    two: dict               # the port at tp = 2


def _shard(params, mode):
    PSH.set_moe_mode(mode or "fsdp")
    try:
        return tp.shard_params(params, GROUP)
    finally:
        PSH.set_moe_mode("fsdp")


@pytest.fixture(scope="module", params=CASES, ids=IDS)
def case(request):
    aid, mode = request.param
    rcfg, pcfg = ref_arch(aid).reduced(), get_arch(aid).reduced()
    rparams = RM.init_params(rcfg, jax.random.PRNGKey(3))
    one = bridge.params_from_numpy(jax.tree_util.tree_map(np.asarray,
                                                          rparams), pcfg, "cpu")
    return Case(rcfg, pcfg, rparams, one, _shard(one, mode))


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    scale = np.abs(want).max()
    assert np.abs(got - want).max() <= REL * scale, \
        (np.abs(got - want).max(), scale)


def _tokens(cfg, n, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, n),
                                                dtype=np.int32)


def _prefix(cfg):
    """A VLM's patch embeddings or an encoder-decoder's frames, else
    None."""
    rng = np.random.default_rng(7)
    n = {"vlm": cfg.num_patches, "encdec": cfg.enc_len}.get(cfg.family)
    return None if n is None else rng.standard_normal(
        (B, n, cfg.d_model)).astype(np.float32)


def _plans(kind, cfg):
    """One grant lowered by both packages: (reference, port)."""
    pages = 4096 if kind == "LBM" else 2
    kw = dict(seq_block=128, d_model=cfg.d_model, d_ff=cfg.d_ff,
              dtype_bytes=4, head_dim=cfg.hd,
              ssm_chunk=cfg.ssm_chunk if cfg.ssm_state else 0)

    def sel(Candidate, Selection):
        return Selection(Candidate(kind=kind, p_need=pages, dram_bytes=0,
                                   flops=0, loops=(), cache_map=(),
                                   usage_limit_bytes=0), pages, 0.0)
    rp = rplan.lower_selection(sel(RCandidate, RSelection), pages, **kw)
    pp = pplan.lower_selection(sel(PCandidate, PSelection), pages, **kw)
    assert rp.describe() == pp.describe()
    return rp, pp


def _t(a):
    return torch.from_numpy(np.array(a))


# ------------------------------------------------------------ prefill --
def test_lm_forward_tp2_matches_tp1_and_reference(case):
    toks = _tokens(case.rcfg, 24)
    pre = _prefix(case.rcfg)
    kw = {} if pre is None else {"embeds_prefix": pre}
    want, _ = RT.lm_forward(case.rparams, jnp.asarray(toks), case.rcfg,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    pkw = {k: _t(v) for k, v in kw.items()}
    with torch.no_grad():
        one, _ = PT.lm_forward(case.one, _t(toks).long(), case.pcfg, **pkw)
        two, _ = PT.lm_forward(case.two, _t(toks).long(), case.pcfg, **pkw)
    _close(two, one)
    _close(two, want)
    assert (two.argmax(-1) == one.argmax(-1)).all()


@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_make_prefill_with_plan_matches_reference(case, kind):
    """A planned one-shot prefill at tp = 2: flash attention on each
    shard's heads, each shard's FFN (each expert's) on its slice."""
    rp, pp = _plans(kind, case.rcfg)
    toks = _tokens(case.rcfg, 32, seed=4)
    pre = _prefix(case.rcfg)
    batch = {"tokens": jnp.asarray(toks)}
    pbatch = {"tokens": _t(toks).long()}
    if pre is not None:
        batch["embeds_prefix"], pbatch["embeds_prefix"] = \
            jnp.asarray(pre), _t(pre)
    want = RM.make_prefill(case.rcfg)(case.rparams, batch, rp)
    with torch.no_grad():
        one = PM.make_prefill(case.pcfg)(case.one, pbatch, pp)
        two = PM.make_prefill(case.pcfg)(case.two, pbatch, pp)
    _close(two, one)
    _close(two, want)


# ------------------------------------------------------------- decode --
def _enc(case):
    pre = _prefix(case.rcfg)
    if case.rcfg.family != "encdec":
        return None, None
    enc = np.asarray(RT.encode(case.rparams, jnp.asarray(pre), case.rcfg))
    return jnp.asarray(enc), _t(enc)


def _ref_decode(case, rp, prompt, forced):
    renc, _ = _enc(case)
    extra = () if renc is None else (renc,)
    rc = RT.init_caches(case.rparams, case.rcfg, B, MAX_LEN)
    _, rc = RT.prefill_chunk(case.rparams, jnp.asarray(prompt), rc,
                             jnp.int32(0), case.rcfg, *extra)
    toks, logits = [], []
    for i in range(8):
        rl, rc = RT.decode_step(case.rparams, jnp.asarray(forced[:, i:i + 1]),
                                rc, jnp.int32(PROMPT + i), case.rcfg, *extra,
                                plan=rp)
        logits.append(np.asarray(rl)[:, -1])
        toks.append(np.asarray(RM._greedy_next_token(case.rcfg)(rl)))
    return np.stack(toks), np.stack(logits)


def _port_decode(case, params, pp, prompt, forced):
    _, penc = _enc(case)
    pc = PT.init_caches(params, case.pcfg, B, MAX_LEN, device="cpu")
    with torch.no_grad():
        _, pc = PT.prefill_chunk(params, _t(prompt).long(), pc, 0, case.pcfg,
                                 penc)
        greedy = PM._greedy_next_token(case.pcfg)
        forced_t = _t(forced).long()
        toks, logits = [], []

        def teacher(lg):
            logits.append(lg[:, -1].numpy())
            toks.append(greedy(lg).numpy())
            return forced_t[:, len(toks)]

        PT.decode_epoch(params, forced_t[:, :1], pc, PROMPT, case.pcfg, 8,
                        next_token_fn=teacher, enc_out=penc, plan=pp)
    return np.stack(toks), np.stack(logits), pc


def _whole(cache):
    """A layer's cache with a head-split cache's pieces put back together
    along the heads, in shard order, under their plain names."""
    out = {}
    for name, leaf in cache.items():
        base = name.partition("@")[0]
        out[base] = (leaf if base not in out
                     else torch.cat([out[base], leaf], dim=2))
    return out


@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_decode_epoch_tp2_teacher_forced(case, kind):
    """A prompt chunk, then 8 teacher-forced decode steps under the plan:
    tp = 2 against tp = 1 and the reference's decode steps; the caches
    the two groups leave agree too."""
    rp, pp = _plans(kind, case.rcfg)
    prompt = _tokens(case.rcfg, PROMPT, seed=1)
    forced = _tokens(case.rcfg, 9, seed=2)
    want_tok, want = _ref_decode(case, rp, prompt, forced)
    one_tok, one, c1 = _port_decode(case, case.one, pp, prompt, forced)
    two_tok, two, c2 = _port_decode(case, case.two, pp, prompt, forced)
    _close(two, one)
    _close(two, want)
    np.testing.assert_array_equal(two_tok, one_tok)
    np.testing.assert_array_equal(two_tok, want_tok)
    for a, b in zip(c1, c2):
        b = _whole(b)
        assert b.keys() == a.keys()
        for name in a:
            _close(b[name].float(), a[name].float())


def test_tp2_repeats_bitwise(case):
    rp, pp = _plans("LWM", case.rcfg)
    prompt = _tokens(case.rcfg, PROMPT, seed=1)
    forced = _tokens(case.rcfg, 9, seed=2)
    a = _port_decode(case, case.two, pp, prompt, forced)
    b = _port_decode(case, case.two, pp, prompt, forced)
    np.testing.assert_array_equal(a[1], b[1])
    for x, y in zip(a[2], b[2]):
        for name in x:
            assert torch.equal(x[name], y[name])


# ------------------------------------------------- the plan kernels --
def _spy(monkeypatch):
    """Record the weight shape of every cache_matmul (B's K x N) and
    block_fused_ffn (d x f) call; the CPU runs their plain versions."""
    calls = []
    mm, ffn = kmm.cache_matmul, kffn.block_fused_ffn

    def spy_mm(a, b, tile):
        calls.append(("cache_matmul", tuple(b.shape)))
        return mm(a, b, tile)

    def spy_ffn(x, wg, wu, wd, tile):
        calls.append(("block_fused_ffn", tuple(wg.shape)))
        return ffn(x, wg, wu, wd, tile)
    monkeypatch.setattr(kmm, "cache_matmul", spy_mm)
    monkeypatch.setattr(kffn, "block_fused_ffn", spy_ffn)
    return calls


@pytest.mark.parametrize("arch, mode", [("yi-9b", None),
                                        ("olmoe-1b-7b", "ep2d")])
@pytest.mark.parametrize("kind", ["LBM", "LWM"])
def test_plan_kernels_run_at_shard_shapes(monkeypatch, arch, mode, kind):
    """Under tp = 2 every plan kernel call sees a shard's d_ff slice,
    never a whole FFN weight, and there are twice the tp = 1 calls."""
    cfg = get_arch(arch).reduced()
    one = PM.init_params(cfg, 0, "cpu")
    two = _shard(one, mode)
    _, pp = _plans(kind, cfg)
    calls = _spy(monkeypatch)
    toks = torch.from_numpy(_tokens(cfg, 32)).long()
    with torch.no_grad():
        PM.make_prefill(cfg)(one, {"tokens": toks}, pp)
        n_one, whole = len(calls), set(calls)
        calls.clear()
        PM.make_prefill(cfg)(two, {"tokens": toks}, pp)
    f, d = cfg.d_ff, cfg.d_model
    assert n_one > 0 and len(calls) == 2 * n_one
    half = ({("cache_matmul", (d, f // 2)), ("cache_matmul", (f // 2, d))}
            if kind == "LWM" else {("block_fused_ffn", (d, f // 2))})
    assert set(calls) == half
    assert not set(calls) & whole


# ---------------------------------------------------------- placement --
def test_params_span_the_group_and_nothing_else():
    """test_fleet.py:166's placement in the port's terms: some leaves
    span both devices of the group, every piece sits on its shard's
    device, every other leaf on the group's first device, and each piece
    holds 1/tp of its leaf's bytes.  Two distinct devices (the CPU and
    the meta device) make the placement visible."""
    cfg = get_arch("yi-9b").reduced()
    params = PM.init_params(cfg, 0, "cpu")
    whole = {id(x): x.numel() for x in tp.leaves(params)}
    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("cpu"), torch.device("meta")]
    group = PMesh.ServingMesh(grid.reshape(1, 2))
    placed = tp.shard_params(params, group)
    assert not any(tp.is_sharded(x) for x in tp.leaves(params))
    leaves = tp.leaves(placed)
    split = [x for x in leaves if tp.is_sharded(x)]
    assert split and all(x.devices == [torch.device("cpu"),
                                       torch.device("meta")] for x in split)
    assert all(x.device == torch.device("cpu")
               for x in leaves if not tp.is_sharded(x))
    for x in split:
        assert [p.numel() for p in x.pieces] == [x.shape.numel() // 2] * 2
    by_shard = tp.bytes_by_shard(placed)
    assert by_shard[1] == sum(p.numel() * 4 for x in split
                              for p in x.pieces[1:])
    assert sum(by_shard) == 4 * sum(whole.values())
    # a tree placed before keeps its pieces
    again = tp.shard_params(placed, group)
    assert all(a is b for a, b in zip(tp.leaves(again), leaves))
    # the rules' own split: heads, d_ff, vocab
    assert split[0].dim == 0 and tuple(split[0].shape) == (
        cfg.padded_vocab, cfg.d_model)


@pytest.mark.parametrize("arch", ["yi-9b", "zamba2-2.7b", "whisper-tiny"])
@pytest.mark.parametrize("kv_dtype", [None, "int8"])
def test_head_split_caches_live_on_their_shards(arch, kv_dtype):
    """Over a group that splits attention by heads, each attention
    layer's cache is one piece a shard, its Hkv / tp KV heads, on the
    shard's device (the CPU and the meta device make it visible); a
    Mamba2 state stays on the first device."""
    cfg = get_arch(arch).reduced()
    grid = np.empty(2, dtype=object)
    grid[:] = [torch.device("cpu"), torch.device("meta")]
    placed = tp.shard_params(PM.init_params(cfg, 0, "cpu"),
                             PMesh.ServingMesh(grid.reshape(1, 2)))
    caches = PT.init_caches(placed, cfg, B, MAX_LEN, kv_dtype=kv_dtype)
    names = {"k", "v"} | ({"k_scale", "v_scale"} if kv_dtype else set())
    for i, c in enumerate(caches):
        if not PT.is_attention_layer(cfg, i):
            assert {x.device.type for x in c.values()} == {"cpu"}
            continue
        assert set(c) == {f"{n}@{r}" for n in names for r in (0, 1)}
        for name, leaf in c.items():
            r = int(name.partition("@")[2])
            assert leaf.device.type == ("cpu", "meta")[r]
            assert leaf.shape[2] == cfg.num_kv_heads // 2
            assert PT.is_kv_leaf(name)


def test_expert_split_decode_runs_each_entry_once(monkeypatch):
    """olmoe under "fsdp": a one-token decode step runs each (token,
    expert) entry on the one shard that holds its expert, so the shards'
    rows add up to G x K; the form a CUDA graph capture takes (every
    entry on each shard, its own kept) gives the same output."""
    cfg = get_arch("olmoe-1b-7b").reduced()
    two = _shard(PM.init_params(cfg, 0, "cpu"), "fsdp")
    moe = two["layers"][0]["mlp"]
    assert tp.is_sharded(moe["gate"]) and moe["gate"].dim == 0
    rows, inner = [], PMoE._expert_rows

    def spy(wg, wu, wd, x, e):
        rows.append(x.shape[0])
        return inner(wg, wu, wd, x, e)
    monkeypatch.setattr(PMoE, "_expert_rows", spy)
    G, K = 3, cfg.experts_per_token
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(G, 1, cfg.d_model, generator=gen)
    top_e = torch.stack([torch.randperm(cfg.num_experts, generator=gen)[:K]
                         for _ in range(G)])[:, None]
    top_p = torch.rand(G, 1, K, generator=gen)
    eager = PMoE._decode_moe(moe, x, top_p, top_e)
    assert sum(rows) == G * K and len(rows) <= 2
    rows.clear()
    monkeypatch.setattr(tp, "capturing", lambda: True)
    static = PMoE._decode_moe(moe, x, top_p, top_e)
    assert rows == [G * K, G * K]
    _close(static, eager)


def test_shard_refuses_plain_ops():
    w = tp.shard_leaf(torch.ones(4, 6), (None, "model"), [torch.device("cpu")] * 2)
    assert tp.is_sharded(w) and tuple(w.shape) == (4, 6)
    with pytest.raises(TypeError, match="tensor-parallel"):
        torch.matmul(torch.ones(2, 4), w)
    with pytest.raises(TypeError, match="tensor-parallel"):
        torch.ones(2, 4) @ w
    with pytest.raises(TypeError, match="tensor-parallel"):
        w[0]
    assert [tuple(p.shape) for p in w.pieces] == [(4, 3), (4, 3)]


def test_heads_cut_by_the_split_attend_on_the_first_device():
    """H = 3 query heads over one KV head: wq's 96 columns split in two
    cut a head, so q, k and v are concatenated before attention and the
    context is cut by wo's rows; logits match tp = 1."""
    cfg = dataclasses.replace(get_arch("yi-9b").reduced(), num_heads=3,
                              num_kv_heads=1)
    one = PM.init_params(cfg, 0, "cpu")
    two = _shard(one, None)
    assert tp.is_sharded(two["layers"][0]["attn"]["wq"]["w"])
    assert tp.is_sharded(two["layers"][0]["attn"]["wk"]["w"])
    toks = torch.from_numpy(_tokens(cfg, 24)).long()
    with torch.no_grad():
        a, _ = PT.lm_forward(one, toks, cfg)
        b, _ = PT.lm_forward(two, toks, cfg)
    _close(b, a)


def test_unsplit_leaves_and_indivisible_dims_stay_whole():
    """whisper's full vocab (51,865) does not divide by 2: its table
    stays whole, as ``_spec_for_path`` rules."""
    cfg = dataclasses.replace(get_arch("whisper-tiny").reduced(),
                              vocab_size=51865)
    params = PM.init_params(cfg, 0, "cpu")
    placed = tp.shard_params(params, GROUP)
    assert (cfg.padded_vocab % 2 == 1) == (not tp.is_sharded(
        placed["embed"]["table"]))
    assert tp.is_sharded(placed["layers"][0]["attn"]["wq"]["w"])


# ------------------------------------------------------------- server --
def _server(device, pipeline=True, kv_dtype="native"):
    specs = [TenantSpec("yi-9b", n_inferences=6),
             TenantSpec("yi-9b", n_inferences=6, prompt_len=64)]
    return PS.MultiTenantServer([], batch=1, max_len=256, epoch_len=4,
                                total_pages=64, tenants=specs, device=device,
                                pipeline=pipeline, kv_dtype=kv_dtype)


def _trace(srv):
    return {t.tid: (t.choices, [p.describe() for p in t.plans], t.chunks)
            for t in srv.tenants}


@pytest.mark.parametrize("kv_dtype", ["native", "int8", "fp8_e4m3"])
def test_server_tp2_equals_tp1_traces_and_tokens(kv_dtype):
    """A (1, 2) group serves the same grants, plans and prompt chunks as
    one device (the control stack does not see tp) and the same greedy
    tokens, with each KV precision (each shard writes and reads its KV
    heads' codes and scales); its serial loop equals its pipelined one
    bitwise."""
    one = _server(PMesh.make_serving_mesh(1, devices=["cpu"]),
                  kv_dtype=kv_dtype)
    two = _server(GROUP, kv_dtype=kv_dtype)
    serial = _server(GROUP, pipeline=False, kv_dtype=kv_dtype)
    assert tp.is_sharded(
        two.tenants[0].params["layers"][0]["mlp"]["down"]["w"])
    a, b, c = one.run(6), two.run(6), serial.run(6)
    assert _trace(one) == _trace(two)
    assert b["host"]["tp"] == 2 and a["host"]["tp"] == 1
    assert b["host"]["captured"] is False      # the CPU captures nothing
    for tid, info in a["tenants"].items():
        np.testing.assert_array_equal(b["tenants"][tid]["output"],
                                      info["output"])
        np.testing.assert_array_equal(c["tenants"][tid]["output"],
                                      b["tenants"][tid]["output"])


def test_server_leaves_the_params_fn_tree_whole():
    """A tp = 2 server places a copy of what ``params_fn`` hands it: the
    caller's tree keeps its whole tensors, so a tp = 1 server on the same
    memoised tree serves it after, with the same tokens."""
    memo = {}

    def params_fn(cfg, pkey):
        if pkey not in memo:
            memo[pkey] = PM.init_params(cfg, pkey, "cpu")
        return memo[pkey]

    def server(device):
        return PS.MultiTenantServer(
            [], batch=1, max_len=128, epoch_len=4, total_pages=64,
            tenants=[TenantSpec("yi-9b", n_inferences=4, prompt_len=32)],
            device=device, params_fn=params_fn)
    two = server(GROUP).run(4)
    assert memo and not any(tp.is_sharded(x) for x in tp.leaves(memo))
    one = server(PMesh.make_serving_mesh(1, devices=["cpu"])).run(4)
    for tid, info in one["tenants"].items():
        np.testing.assert_array_equal(two["tenants"][tid]["output"],
                                      info["output"])


def test_reference_moe_modes_are_the_ports():
    assert RSH.MOE_MODES == PSH.MOE_MODES
