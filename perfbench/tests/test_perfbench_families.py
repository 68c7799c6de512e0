"""The gqa_swiglu family gives the weights and FLOP counts that the
harness gave before model families were files of their own: the
published configs' counts and the tiny configs' weight sets, pinned."""
import hashlib
import json

import pytest
import torch

from perfbench import harness
from perfbench.families import gqa_swiglu

from conftest import DATA

CONFIGS = harness.ROOT / "perfbench" / "configs"

# (matmul_flops_per_token, span_flops(0, 256), span_flops(256, 2048)) of
# each published config's arch, as roofline.py counted them before the
# count moved into the family
FLOPS = {"granite-3-8b": (16_341_032_960, 4_204_863_160_320,
                          30_636_632_965_120),
         "olmoe-1b-7b": (2_357_723_136, 607_888_867_328, 4_495_740_239_872)}

# sha256 (see _digest) of the weight sets of instances 0 and 1 that
# perfbench/weights.py's make() gave on the CPU before it moved into
# gqa_swiglu.make, unchanged
WEIGHTS = {
    ("tiny-dense", 123): (
        "b65f24acbdf5e75fd63ca9b4bb7a1283e059008f90b133d3dc4ccb6cd2b8e852",
        "f9e0ac0af9049f0b622b06d00972ccd43f087ad268c86b4c01688c096c838a79"),
    ("tiny-dense", 7): (
        "a2dc5a0caa3a1593d9d3b4da2fcb4c20629b4ba71a45c4bb922abb445b1fd122",
        "729eadd7afc58c67db5750bc692e8aa6c7a94fef35e192a11945dcd2fe169563"),
    ("tiny-moe", 123): (
        "8ad037414d26f0f670ad20d19998653fbaa2997219c5eca4885b83eac3b86a1a",
        "6c8857f0a8af626e1c9f5efaa75cf4d84d96dbca4b1ab2f1d7d2d03ea9842f6e"),
    ("tiny-moe", 7): (
        "af9eba1c45938958ed7fcfdc8493f4a445191766f5e658756cff70d1c73e67dc",
        "8675551c3ab3fca0585646874980ea859e54daf2fa9abd2715d1207ce69e1838"),
}


def _leaves(tree, path=""):
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], f"{path}/{k}")
    else:
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}/{i}")


def _digest(weights) -> str:
    """Every leaf's path, dtype, shape and bytes, in path order."""
    h = hashlib.sha256()
    for path, t in _leaves(weights):
        h.update(f"{path}:{t.dtype}:{tuple(t.shape)}".encode())
        h.update(t.contiguous().view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_published_flop_counts_are_pinned(name):
    arch = json.loads((CONFIGS / f"{name}.json").read_text())["arch"]
    per_token, prompt, decode = FLOPS[name]
    assert gqa_swiglu.matmul_flops_per_token(arch) == per_token
    assert gqa_swiglu.span_flops(arch, 0, 256) == prompt
    assert gqa_swiglu.span_flops(arch, 256, 2048) == decode


@pytest.mark.parametrize("name, seed", sorted(WEIGHTS))
def test_weight_sets_are_pinned(name, seed):
    arch = json.loads((DATA / f"{name}.json").read_text())["arch"]
    got = tuple(_digest(gqa_swiglu.make(arch, seed, i, "cpu"))
                for i in range(2))
    assert got == WEIGHTS[name, seed]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_published_configs_name_their_family(name):
    config = json.loads((CONFIGS / f"{name}.json").read_text())
    assert config["family"] == "gqa_swiglu"
