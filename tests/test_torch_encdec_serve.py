"""The port's MultiTenantServer with encoder-decoder (whisper-tiny) and
VLM (llava-next-mistral-7b) tenants against the JAX package's, at the
reduced configs (fp32), the reference's params and prompts injected
(``params_fn`` / ``prompt_fn``).

An encoder-decoder tenant decodes against a fixed encoder output, zeros
[batch, enc_len, d_model] built once at admission (the reference's
frontend is a stub); a VLM tenant serves its prompt through the dense
decoder.  Scenarios: two whisper residents (one bucket: the reference
stacks their ``enc``, the port passes each tenant's own buffer) and a
prompt arrival, the same under ``kv_dtype="int8"`` (whisper stays
native), and a llava resident and arrival.  The scheduling side is the
reference's copy, so choices, plans, prefill chunks, reservations, NEC
counters and token streams must be exactly equal, and the port's serial
and pipelined loops bit-identical.  Also: departure frees ``enc``,
``_choose_kv_dtype`` under ``int8`` and ``auto``, prefix dedup leaving
whisper out, and the CLI serving both archs.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

from repro.launch import serve as RS
from repro.models import model as RM
from repro.models.base import get_arch as ref_arch
from repro.sim import driver as RD
from repro_torch.bridge import params_from_numpy
from repro_torch.launch import serve as PS
from repro_torch.models.base import get_arch as port_arch
from repro_torch.sim import driver as PD

WHISPER, LLAVA = "whisper-tiny", "llava-next-mistral-7b"
SERVER = dict(batch=2, max_len=128, epoch_len=4, total_pages=64)
STEPS = 16
_REF_PARAMS = {}


def _ref_cfg(cfg):
    return ref_arch(cfg.name.removesuffix("-smoke")).reduced()


def _ref_params(cfg, pkey):
    key = (cfg.name, pkey)
    if key not in _REF_PARAMS:
        tree = RM.init_params(_ref_cfg(cfg), jax.random.PRNGKey(pkey))
        _REF_PARAMS[key] = jax.tree_util.tree_map(np.asarray, tree)
    return params_from_numpy(_REF_PARAMS[key], cfg, "cpu")


def _ref_prompt(spec, i, cfg, batch):
    rspec = RD.TenantSpec(spec.model, prompt_len=spec.prompt_len,
                          prompt_seed=spec.prompt_seed,
                          prefix_len=spec.prefix_len,
                          prefix_seed=spec.prefix_seed)
    return RS._prompt_tokens(rspec, i, _ref_cfg(cfg), batch)


def _servers(arch_ids, specs, **kw):
    """(reference, port) servers of the same scenario."""
    kw = {**SERVER, **kw}
    ref = RS.MultiTenantServer(arch_ids, tenants=[RD.TenantSpec(a, **t)
                                                  for a, t in specs], **kw)
    port = PS.MultiTenantServer(
        arch_ids, tenants=[PD.TenantSpec(a, **t) for a, t in specs],
        device="cpu", params_fn=_ref_params, prompt_fn=_ref_prompt, **kw)
    return ref, port


def _outputs(out):
    return {tid: info["output"] for tid, info in out["tenants"].items()}


def _same_tokens(a, b):
    assert set(a) == set(b)
    for tid in a:
        np.testing.assert_array_equal(a[tid], b[tid], err_msg=tid)


SCENARIOS = {
    # two residents decode as one bucket; the arrival's 40-token prompt
    # prefills in one chunk, then decodes 6 steps and departs
    "whisper": ([WHISPER, WHISPER],
                [(WHISPER, dict(arrive_at=4.0, prompt_len=40,
                                n_inferences=6))], {}),
    "whisper_int8": ([WHISPER],
                     [(WHISPER, dict(arrive_at=1.0, prompt_len=16,
                                     n_inferences=4))],
                     dict(kv_dtype="int8")),
    "llava": ([LLAVA], [(LLAVA, dict(arrive_at=4.0, prompt_len=40,
                                     n_inferences=6))], {}),
}


@pytest.fixture(scope="module", params=sorted(SCENARIOS))
def runs(request):
    """(name, (ref, out), (port, out), (port serial, out))."""
    residents, specs, kw = SCENARIOS[request.param]
    ref, port = _servers(residents, specs, **kw)
    _, serial = _servers(residents, specs, pipeline=False, **kw)
    return request.param, ((ref, ref.run(steps=STEPS)),
                           (port, port.run(steps=STEPS)),
                           (serial, serial.run(steps=STEPS)))


def test_server_trace_equals_reference(runs):
    """Grants, plans, prefill chunks, reservations, NEC counters and
    token streams equal the reference's."""
    name, ((ref, ref_out), (port, port_out), _) = runs
    assert [t.tid for t in ref.tenants] == [t.tid for t in port.tenants]
    for r, p in zip(ref.tenants, port.tenants):
        assert p.choices == r.choices, p.tid
        assert [x.describe() for x in p.plans] == \
            [x.describe() for x in r.plans], p.tid
        assert p.chunks == r.chunks, p.tid
        assert (p.kv_dtype, p.kv_wanted, p.kv_reserved) == \
            (r.kv_dtype, r.kv_wanted, r.kv_reserved), p.tid
        rr, pr = ref_out["tenants"][r.tid], port_out["tenants"][p.tid]
        for key in ("tokens", "choices", "prefill_chunks", "lbm_frac",
                    "kv_dtype", "prefill_computed", "departed", "state"):
            assert pr[key] == rr[key], (p.tid, key)
    _same_tokens(_outputs(port_out), _outputs(ref_out))
    assert port_out["dram_bytes"] == ref_out["dram_bytes"] > 0
    assert (dataclasses.astuple(port.nec.traffic)
            == dataclasses.astuple(ref.nec.traffic))
    assert ({k: dataclasses.astuple(v)
             for k, v in port.nec.ledger.per_tenant.items()}
            == {k: dataclasses.astuple(v)
                for k, v in ref.nec.ledger.per_tenant.items()})
    assert port.cache.free_pages == ref.cache.free_pages
    assert all(t.tokens_served > 0 for t in port.tenants)
    if name.startswith("whisper"):
        # the decode FFN is granted LBM at the reduced width, so the
        # decode path runs the fused kernel's plain version on the CPU
        assert any(c.startswith("LBM") for t in port.tenants
                   for c in t.choices)
    if name == "whisper":
        # the residents decoded as one bucket, each with its own enc
        assert any(key[0] == "bucket" for key in port._fused_jits.keys())


def test_server_serial_and_pipelined_bit_identical(runs):
    _, (_, (_, pipe_out), (_, serial_out)) = runs
    assert serial_out["mode"] == "serial"
    _same_tokens(_outputs(serial_out), _outputs(pipe_out))


def test_enc_lives_from_admission_to_departure(runs):
    """Each whisper tenant holds its own zero ``enc`` [batch, enc_len,
    d_model] in the compute dtype while it is admitted; a departure
    frees it.  A llava tenant has none."""
    name, (_, (port, _), _) = runs
    cfg = port.tenants[0].cfg
    encs = [t.enc for t in port.tenants if not t.departed]
    departed = [t for t in port.tenants if t.departed]
    assert departed and all(t.enc is None for t in departed)
    if name == "llava":
        assert all(e is None for e in encs)
        return
    assert encs
    assert len({e.data_ptr() for e in encs}) == len(encs)
    for e in encs:
        assert e.shape == (port.batch, cfg.enc_len, cfg.d_model)
        assert e.dtype == cfg.torch_dtype and not e.any()


@pytest.mark.parametrize("kv_dtype", ["int8", "auto"])
@pytest.mark.parametrize("arch", [WHISPER, LLAVA])
def test_choose_kv_dtype_equals_reference(arch, kv_dtype):
    """An encoder-decoder tenant stays native under ``int8`` and under
    ``auto`` in a pool too small for its native quote; a VLM tenant
    takes the rung the reference's method picks."""
    cfg = port_arch(arch).reduced()
    pool = PS._kv_reserve_pages(cfg, 2, 64, "int8") + 1
    assert PS._kv_reserve_pages(cfg, 2, 64) > pool
    kw = dict(SERVER, total_pages=pool, kv_dtype=kv_dtype)
    ref = RS.MultiTenantServer([], **kw)
    port = PS.MultiTenantServer([], device="cpu", **kw)
    got = port._choose_kv_dtype(cfg, PD.TenantSpec(arch, prompt_len=64))
    want = ref._choose_kv_dtype(ref_arch(arch).reduced(),
                                RD.TenantSpec(arch, prompt_len=64))
    assert got == want
    assert (got == "native") == (arch == WHISPER)


def test_prefix_dedup_leaves_whisper_out():
    """Session arrivals of whisper under ``prefix_dedup``: none registers
    or attaches (its cross-attention reads the encoder, not the prompt),
    every prompt prefills in full, as in the reference."""
    def specs(cls):
        return [cls(WHISPER, arrive_at=at, n_inferences=4, prompt_len=32,
                    param_seed=5, prompt_seed=7, prefix_len=32, prefix_seed=3)
                for at in (0.0, 4.0)]
    kw = dict(SERVER, batch=1)
    ref = RS.MultiTenantServer([], tenants=specs(RD.TenantSpec),
                               prefix_dedup=True, **kw)
    port = PS.MultiTenantServer([], tenants=specs(PD.TenantSpec),
                                prefix_dedup=True, device="cpu",
                                params_fn=_ref_params, prompt_fn=_ref_prompt,
                                **kw)
    ref_out, out = ref.run(STEPS), port.run(STEPS)
    assert all(t.dedup is None for t in port.tenants)
    assert not port.prefix.entries
    assert out["prefix"] == ref_out["prefix"]
    for info in out["tenants"].values():
        assert info["prefix_hit"] == 0 and info["prefill_computed"] == 32
    _same_tokens(_outputs(out), _outputs(ref_out))


def test_cli_serves_whisper_and_llava(capsys):
    """``python -m repro_torch.launch.serve --archs whisper-tiny
    llava-next-mistral-7b`` on the CPU (reduced): two residents and two
    arrivals, the reference's ``[serve]`` lines."""
    out = PS.main(["--device", "cpu", "--archs", WHISPER, LLAVA,
                   "--steps", "8", "--arrivals", "2", "--prompt-len", "32",
                   "--decode-budget", "4", "--epoch-len", "4"])
    lines = capsys.readouterr().out.splitlines()
    tids = list(out["tenants"])
    assert len(tids) == 4
    assert {t.split(":", 1)[1] for t in tids[:2]} == {WHISPER, LLAVA}
    for tid, ln in zip(tids, lines):
        assert ln.startswith(f"[serve] {tid}: ") and " tokens, LBM " in ln
    assert all(info["tokens"] > 0 for info in out["tenants"].values())
    assert lines[len(tids)].startswith("[serve] pipelined/interleaved")
