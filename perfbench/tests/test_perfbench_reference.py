"""The gqa_swiglu family's plain reference against the program's own
forward, at small widths on the CPU, both in float32 on the benchmark's
weights."""
import json

import numpy as np
import pytest
import torch

from perfbench import harness
from perfbench.families import gqa_swiglu as ref
from perfbench.reference import compare

from conftest import DATA


def _arch(name):
    arch = dict(json.loads((DATA / f"{name}.json").read_text())["arch"],
                dtype="float32")
    arch["name"] += "-f32"
    return arch


@pytest.mark.parametrize("name", ["tiny-dense", "tiny-moe"])
def test_reference_matches_the_program_forward(name):
    from repro_torch.models.transformer import lm_forward
    arch = _arch(name)
    cfg = harness.register_arch({"arch": arch})
    w = ref.make(arch, 123, 0, "cpu")
    tokens = torch.as_tensor(np.random.default_rng(0).integers(
        0, arch["vocab_size"], (3, 40)))
    with torch.no_grad():
        want, _ = lm_forward(w, tokens, cfg, serve_prefill=True)
    got = ref.logits(w, arch, ref.hidden(w, arch, tokens))
    V = arch["vocab_size"]
    scale = want[..., :V].abs().max()
    assert (got[..., :V] - want[..., :V]).abs().max() <= 1e-4 * scale
    assert (got[..., V:] == ref.NEG).all()


def test_gaps_read_the_served_tokens():
    arch = _arch("tiny-dense")
    w = ref.make(arch, 7, 0, "cpu")
    prompt = np.random.default_rng(1).integers(0, arch["vocab_size"], 16)
    toks, served = list(prompt), []
    for _ in range(6):                  # greedy on the reference itself
        lg = ref.logits(w, arch, ref.hidden(w, arch, torch.tensor([toks])))
        served.append(int(lg[0, -1].argmax()))
        toks.append(served[-1])
    served = np.array(served)
    out = compare.gaps(ref, w, arch, [(prompt, served)], "cpu",
                       control=True)
    assert out["gap"] == 0.0 and out["missed"] == 0 and out["tokens"] == 6
    wrong = served.copy()
    wrong[3] = (wrong[3] + 1) % arch["vocab_size"]
    bad = compare.gaps(ref, w, arch, [(prompt, wrong)], "cpu")
    assert bad["gap"] > 0 and bad["missed"] >= 1
    assert bad["where"] == {"row": 0, "served_index": 3}
    r = compare.readings([out, bad])
    assert r["mismatch_share"] == pytest.approx(100 * bad["missed"] / 12)
