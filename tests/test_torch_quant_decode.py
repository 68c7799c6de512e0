"""Quantized-KV decode and serving in the port against the JAX package.

Mirrors tests/test_quant_decode.py on reduced yi-9b (fp32), with the
reference's params handed to the port through ``repro_torch.bridge``:

* after one ``prefill_chunk`` the port's int8 and fp8 caches equal the
  reference's: scales within rtol 1e-6, codes equal except where a K/V
  value sits within rounding noise of a code boundary (at most one code
  step; measured here: 0 of 69,632 codes differ for either type, the
  largest scale difference 7.1e-7 relative);
* chunked and one-shot prefill write the same quantized cache in the
  port, held to the reference's bounds (one code, fewer than 1e-3 of the
  codes); measured here they are bitwise equal;
* teacher-forced decode over 8 steps after a 128-token prompt stays
  within the reference's yi-9b bounds of the native cache (cosine >=
  0.999, max |logit error| <= 0.35; measured: int8 0.080, fp8 0.344),
  and the port's quantized stream agrees with the reference's within
  1e-3 (fp32 sums in another order; measured 3.1e-5 at logits of ~100);
* structure: a native cache has no scale leaves, dtypes stay pinned
  through ``decode_epoch``, a default server equals an explicit
  ``kv_dtype="native"`` one bitwise;
* serving: the reference's ``int8``, ``auto`` ladder and page-scale
  scenarios give equal traces, reservations and token streams, page
  scales within rtol 1e-5 (:data:`PAGE_SCALE_RTOL`), resident tenants
  stay native, and the port's serial and pipelined loops are bitwise
  equal with a quantized tenant.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models import transformer as RT
from repro.models.base import get_arch as ref_arch
from repro.sim.driver import TenantSpec as RSpec
from repro_torch.bridge import caches_from_numpy, params_from_numpy
from repro_torch.launch import serve as PS
from repro_torch.models import model as PM
from repro_torch.models import transformer as PT
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim.driver import TenantSpec as PSpec

KV = ["int8", "fp8_e4m3"]
STEPS, PROMPT = 8, 128
MIN_COS, MAX_ERR = 0.999, 0.35      # tests/test_quant_decode.py, yi-9b
STREAM_TOL = 1e-3                   # port against reference, same params
# Page scales are maxima of row scales (amax / qmax) of K/V computed by
# two frameworks' fp32 sums, after chunked prefill through both layers:
# measured up to 2.4e-6 relative (one page of five), so 1e-5.
PAGE_SCALE_RTOL = 1e-5


@pytest.fixture(scope="module")
def model():
    rcfg, pcfg = ref_arch("yi-9b").reduced(), port_arch("yi-9b").reduced()
    rp = RM.init_params(rcfg, jax.random.PRNGKey(0))
    pp = params_from_numpy(jax.tree_util.tree_map(np.asarray, rp), pcfg, "cpu")
    toks = np.array(jax.random.randint(jax.random.PRNGKey(1), (1, PROMPT), 0,
                                       rcfg.vocab_size))
    return rcfg, pcfg, rp, pp, toks


def _ordinal(q):
    """Codes as integers that step by one between neighbouring codes:
    int8 as is; fp8_e4m3 by its sign-magnitude bits."""
    if q.dtype == torch.int8:
        return q.int()
    bits = q.view(torch.uint8).int()
    return torch.where(bits >= 128, -(bits & 0x7F), bits & 0x7F)


def _port_prefill(model, kv, chunks=(PROMPT,)):
    _, pcfg, _, pp, toks = model
    caches = PT.init_caches(pp, pcfg, 1, PROMPT + STEPS, kv_dtype=kv,
                            device="cpu")
    start = 0
    for n in chunks:
        logits, caches = PT.prefill_chunk(
            pp, torch.from_numpy(toks[:, start:start + n]).long(), caches,
            start, pcfg)
        start += n
    return logits, caches


def _code_steps(a, b):
    """Per code buffer of two cache lists: (codes differing, largest
    difference in code steps); asserts the scale leaves within 1e-6."""
    diff, worst = 0, 0
    for la, lb in zip(a, b):
        assert set(la) == set(lb) == {"k", "v", "k_scale", "v_scale"}
        for name in ("k", "v"):
            assert la[name].dtype == lb[name].dtype
            d = (_ordinal(la[name]) - _ordinal(lb[name])).abs()
            diff += int((d != 0).sum())
            worst = max(worst, int(d.max()))
        for name in ("k_scale", "v_scale"):
            assert la[name].dtype == lb[name].dtype == torch.float32
            np.testing.assert_allclose(la[name].numpy(), lb[name].numpy(),
                                       rtol=1e-6, atol=0)
    return diff, worst


@pytest.mark.parametrize("kv", KV)
def test_quantized_cache_equals_reference_after_prefill(model, kv):
    rcfg, pcfg, rp, _, toks = model
    rc = RT.init_caches(rp, rcfg, 1, PROMPT + STEPS, kv_dtype=kv)
    _, rc = RT.prefill_chunk(rp, jnp.asarray(toks), rc, jnp.int32(0), rcfg)
    ref = caches_from_numpy(jax.tree_util.tree_map(np.asarray, rc), pcfg,
                            "cpu")
    _, port = _port_prefill(model, kv)
    diff, worst = _code_steps(port, ref)
    n = sum(layer["k"].numel() + layer["v"].numel() for layer in port)
    assert worst <= 1 and diff < 1e-3 * n, (diff, worst)


@pytest.mark.parametrize("kv", KV)
def test_quant_chunked_prefill_equals_one_shot(model, kv):
    _, one = _port_prefill(model, kv)
    _, chunked = _port_prefill(model, kv, chunks=(64, 64))
    diff, worst = _code_steps(one, chunked)
    n = sum(layer["k"].numel() + layer["v"].numel() for layer in one)
    assert worst <= 1 and diff < 1e-3 * n, (diff, worst)


def test_bridge_carries_stacked_reference_caches(model):
    """Deep stacks keep one stacked dict in the reference; the bridge
    splits it into the port's per-layer list, codes and scales
    bit-exact."""
    rcfg, pcfg, rp, _, _ = model
    rng = np.random.default_rng(0)
    layers = [{k: np.array(v) for k, v in layer.items()} for layer in
              RT.init_caches(rp, rcfg, 1, 16, kv_dtype="fp8_e4m3")]
    for layer in layers:
        layer["k_scale"][:] = rng.random(layer["k_scale"].shape)
    stacked = {k: np.stack([layer[k] for layer in layers]) for k in layers[0]}
    a = caches_from_numpy(layers, pcfg, "cpu")
    b = caches_from_numpy(stacked, pcfg, "cpu")
    assert len(a) == len(b) == pcfg.num_layers
    for la, lb, ln in zip(a, b, layers):
        for name in ln:
            assert la[name].dtype == lb[name].dtype
            assert torch.equal(_ordinal(la[name]) if name in ("k", "v")
                               else la[name],
                               _ordinal(lb[name]) if name in ("k", "v")
                               else lb[name])
        assert torch.equal(la["k_scale"], torch.from_numpy(ln["k_scale"]))


# ------------------------------------------------------------ decode --
@pytest.fixture(scope="module")
def streams(model):
    """Teacher-forced logits per step for a native, an int8 and an fp8
    cache fed the native stream's greedy tokens, in the port; and the
    reference's int8 / fp8 streams fed the same tokens."""
    rcfg, pcfg, rp, pp, toks = model
    st = {}
    for kv in ("native", *KV):
        logits, caches = _port_prefill(model, kv)
        st[kv] = {"caches": caches, "last": logits[:, -1], "logits": []}
    forced = []
    tok = st["native"]["last"].argmax(-1)[:, None]
    for i in range(STEPS):
        forced.append(tok)
        for s in st.values():
            lg, s["caches"] = PT.decode_step(pp, tok, s["caches"], PROMPT + i,
                                             pcfg)
            s["last"] = lg[:, -1]
            s["logits"].append(lg.double().ravel().numpy())
        tok = st["native"]["last"].argmax(-1)[:, None]
    ref = {}
    for kv in KV:
        rc = RT.init_caches(rp, rcfg, 1, PROMPT + STEPS, kv_dtype=kv)
        _, rc = RT.prefill_chunk(rp, jnp.asarray(toks), rc, jnp.int32(0),
                                 rcfg)
        ref[kv] = []
        for i, t in enumerate(forced):
            lg, rc = RT.decode_step(rp, jnp.asarray(t.numpy(), jnp.int32), rc,
                                    jnp.int32(PROMPT + i), rcfg)
            ref[kv].append(np.asarray(lg, np.float64).ravel())
    return {kv: s["logits"] for kv, s in st.items()}, ref


@pytest.mark.parametrize("kv", KV)
def test_quantized_kv_decode_accuracy(streams, kv):
    port, _ = streams
    for a, b in zip(port["native"], port[kv]):
        cos = a @ b / (np.linalg.norm(a) * np.linalg.norm(b))
        assert cos >= MIN_COS, (kv, cos)
        assert np.abs(a - b).max() <= MAX_ERR, (kv, np.abs(a - b).max())


@pytest.mark.parametrize("kv", KV)
def test_quantized_decode_stream_equals_reference(streams, kv):
    port, ref = streams
    assert len(port[kv]) == len(ref[kv]) == STEPS
    for a, b in zip(port[kv], ref[kv]):
        np.testing.assert_allclose(a, b, rtol=0, atol=STREAM_TOL)


def test_native_cache_structure_untouched(model):
    _, pcfg, _, pp, _ = model
    default = PT.init_caches(pp, pcfg, 1, 64, device="cpu")
    native = PT.init_caches(pp, pcfg, 1, 64, kv_dtype="native", device="cpu")
    for a, b in zip(default, native):
        assert set(a) == set(b) == {"k", "v"}
        for name in a:
            assert a[name].dtype == b[name].dtype == pcfg.torch_dtype
            assert a[name].shape == b[name].shape


@pytest.mark.parametrize("kv", KV)
def test_quant_cache_dtypes_pinned_through_decode_epoch(model, kv):
    _, pcfg, _, pp, _ = model
    _, caches = _port_prefill(model, kv)
    want = [{n: (b.dtype, b.shape) for n, b in layer.items()}
            for layer in caches]
    assert want[0]["k"][0] == PT.init_caches(
        None, pcfg, 1, 1, kv_dtype=kv, device="cpu")[0]["k"].dtype
    epoch = PM.make_decode_epoch(pcfg)
    token = torch.zeros((1, 1), dtype=torch.long)
    for e in range(2):
        toks, out = epoch(pp, caches, token, PROMPT + 4 * e, k=4)
        assert out is caches                       # updated in place
        token = toks[:, -1:]
        assert [{n: (b.dtype, b.shape) for n, b in layer.items()}
                for layer in caches] == want


# ----------------------------------------------------------- serving --
_REF_PARAMS = {}


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def _ref_params(cfg, pkey):
    if pkey not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[pkey] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[pkey], cfg, "cpu")


def _ref_prompt(spec, i, cfg, batch):
    return RS._prompt_tokens(RSpec(spec.model, prompt_len=spec.prompt_len), i,
                             _ref_cfg(cfg), batch)


def _specs(cls, kw_list):
    return [cls("yi-9b", **kw) for kw in kw_list]


def _pair(arch_ids, tenants, steps, **server):
    """The reference's server and the port's (reference params and
    prompts injected) on one scenario; returns both servers and runs."""
    ref = RS.MultiTenantServer(arch_ids, tenants=_specs(RSpec, tenants),
                               **server)
    port = PS.MultiTenantServer(arch_ids, tenants=_specs(PSpec, tenants),
                                device="cpu", params_fn=_ref_params,
                                prompt_fn=_ref_prompt, **server)
    return (ref, ref.run(steps)), (port, port.run(steps))


def _assert_same_trace(ref, ref_out, port, port_out):
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices, p.tid
        assert ([x.describe() for x in p.plans]
                == [x.describe() for x in r.plans]), p.tid
        assert p.chunks == r.chunks, p.tid
        assert (p.kv_dtype, p.kv_wanted, p.kv_reserved) == \
            (r.kv_dtype, r.kv_wanted, r.kv_reserved), p.tid
        rr, pr = ref_out["tenants"][r.tid], port_out["tenants"][p.tid]
        assert pr["kv_dtype"] == rr["kv_dtype"] == r.kv_dtype
        np.testing.assert_array_equal(pr["output"], rr["output"],
                                      err_msg=p.tid)
        ps = sorted(port.cache.page_scales_of(p.tid + "#kv").items())
        rs = sorted(ref.cache.page_scales_of(r.tid + "#kv").items())
        assert [k for k, _ in ps] == [k for k, _ in rs], p.tid
        np.testing.assert_allclose([v for _, v in ps], [v for _, v in rs],
                                   rtol=PAGE_SCALE_RTOL, atol=0)
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert port.cache.free_pages == ref.cache.free_pages


INT8_SERVER = dict(batch=1, max_len=256, epoch_len=4, total_pages=32,
                   kv_dtype="int8")
INT8_ARRIVAL = dict(arrive_at=4.0, prompt_len=192, n_inferences=16)


@pytest.fixture(scope="module")
def int8_runs():
    (ref, ref_out), (port, port_out) = _pair(["yi-9b"], [INT8_ARRIVAL], 24,
                                             **INT8_SERVER)
    serial = PS.MultiTenantServer(
        ["yi-9b"], tenants=_specs(PSpec, [INT8_ARRIVAL]), device="cpu",
        params_fn=_ref_params, prompt_fn=_ref_prompt, pipeline=False,
        **INT8_SERVER)
    return (ref, ref_out), (port, port_out), (serial, serial.run(24))


def test_int8_server_equals_reference(int8_runs):
    """A pinned int8 server: the arriving prompt tenant takes int8 and
    its plans carry the +kv:int8 tag; the resident tenant stays native
    with untagged plans, in the plans, the caches and the report."""
    (ref, ref_out), (port, port_out), _ = int8_runs
    _assert_same_trace(ref, ref_out, port, port_out)
    resident, arrival = port.tenants
    assert resident.kv_dtype == "native" and arrival.kv_dtype == "int8"
    assert not any("+kv:" in p.describe() for p in resident.plans)
    assert all(p.describe().endswith("+kv:int8") for p in arrival.plans)
    assert port_out["tenants"][resident.tid]["kv_dtype"] == "native"
    assert arrival.kv_wanted == PS._kv_reserve_pages(
        arrival.cfg, 1, INT8_ARRIVAL["prompt_len"], "int8")


def test_int8_server_serial_and_pipelined_bit_identical(int8_runs):
    _, (_, pipe_out), (_, serial_out) = int8_runs
    assert serial_out["mode"] == "serial"
    for tid, p in pipe_out["tenants"].items():
        s = serial_out["tenants"][tid]
        np.testing.assert_array_equal(s["output"], p["output"], err_msg=tid)
        assert s["kv_dtype"] == p["kv_dtype"]


def test_auto_ladder_downgrades_under_pressure_like_reference():
    """tests/test_quant_decode.py::test_auto_ladder_downgrades_under_
    pressure: a pool of one native plus one fp8 reservation plus 2 pages
    at batch 1; three 256-token arrivals land on native, then a narrow
    rung fully resident, then int8 with a partial reservation."""
    cfg = port_arch("yi-9b").reduced()
    native = PS._kv_reserve_pages(cfg, 1, 256)
    pool = native + PS._kv_reserve_pages(cfg, 1, 256, "fp8_e4m3") + 2
    spec = dict(prompt_len=256, n_inferences=4, param_seed=5)
    (ref, ref_out), (port, port_out) = _pair(
        [], [spec] * 3, 12, kv_dtype="auto", batch=1, max_len=512,
        total_pages=pool, epoch_len=4, steps_per_s=4.0)
    _assert_same_trace(ref, ref_out, port, port_out)
    got = [t.kv_dtype for t in port.tenants]
    assert got[0] == "native" and got[1] in ("fp8_e4m3", "int8")
    assert got[2] == "int8"
    for t in port.tenants[:2]:
        assert t.kv_reserved == t.kv_wanted
    assert port.tenants[2].kv_wanted == PS._kv_reserve_pages(cfg, 1, 256,
                                                              "int8")
    for t in port.tenants:
        tags = {p.describe().partition("+kv:")[2] or "native"
                for p in t.plans}
        assert tags == {t.kv_dtype}, t.tid


def test_page_scales_recorded_for_live_int8_tenant_like_reference():
    spec = dict(prompt_len=256, n_inferences=None, param_seed=5)
    (ref, ref_out), (port, port_out) = _pair(
        [], [spec], 8, kv_dtype="int8", batch=1, max_len=512,
        total_pages=256, epoch_len=4, steps_per_s=4.0)
    _assert_same_trace(ref, ref_out, port, port_out)
    scales = port.cache.page_scales_of("t0:yi-9b#kv")
    pages = port.cache.pages_of("t0:yi-9b#kv")
    assert pages and len(scales) == len(pages)
    assert all(s > 0 for s in scales.values())


def test_default_server_bit_identical_to_explicit_native():
    spec = [PSpec("yi-9b", prompt_len=256, n_inferences=4, param_seed=5)]
    kw = dict(batch=1, max_len=512, total_pages=256, epoch_len=4,
              steps_per_s=4.0, device="cpu", params_fn=_ref_params,
              prompt_fn=_ref_prompt)
    out_d = PS.MultiTenantServer([], tenants=spec, **kw).run(12)
    out_n = PS.MultiTenantServer([], tenants=spec, kv_dtype="native",
                                 **kw).run(12)
    a, b = out_d["tenants"]["t0:yi-9b"], out_n["tenants"]["t0:yi-9b"]
    assert a["kv_dtype"] == b["kv_dtype"] == "native"
    np.testing.assert_array_equal(a["output"], b["output"])


@pytest.mark.parametrize("kv_dtype", ["int4", "bf16", "float8_e4m3fn"])
def test_unknown_kv_dtype_raises(kv_dtype):
    with pytest.raises(ValueError):
        PS.MultiTenantServer(["yi-9b"], device="cpu", kv_dtype=kv_dtype)
