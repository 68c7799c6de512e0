# Verbatim copy of src/repro/sim/workloads.py (lines 1-215: the paper's
# eight benchmark models as layer graphs; conv :21, dwconv :31, fc :41,
# attention :48, transformer_layer :64, lstm_layer :72, resnet50 :82,
# mobilenet_v2 :100, efficientnet_b0 :119, vit_base16 :139, bert_base :148,
# gnmt :157, wav2vec2_base :167, pointpillars :185, benchmark_models :207);
# only the package name in its imports differs. It imports no framework.
"""The eight benchmark models of paper Table I as schedulable layer
graphs (batch-1, int8 inference — the Gemmini-class NPU's native mode).

Convolutions are lowered to im2col GEMMs (M = OH*OW, K = kh*kw*Cin,
N = Cout); depthwise convs become per-channel small GEMMs (reps =
channels) — severely memory-bound, as the paper notes for MobileNet /
EfficientNet.  LSTMs become per-timestep gate GEMMs with B (the weight
matrix) reused across timesteps: the long-reuse-distance case CaMDN's
B-resident mappings exploit.  Residual/SE side paths are folded into
layer I/O footprints (they are bandwidth, not scheduling, effects).
"""
from __future__ import annotations

from typing import Dict, List, Tuple

from repro_torch.core.types import GemmDims, LayerKind, LayerSpec, ModelGraph

EB = 1  # int8


def conv(name: str, h: int, w: int, cin: int, cout: int, k: int = 3,
         stride: int = 1) -> LayerSpec:
    oh, ow = h // stride, w // stride
    return LayerSpec(
        name, LayerKind.GEMM,
        (GemmDims(M=oh * ow, N=cout, K=k * k * cin),),
        input_bytes=h * w * cin * EB, output_bytes=oh * ow * cout * EB,
        weight_bytes=k * k * cin * cout * EB, elem_bytes=EB)


def dwconv(name: str, h: int, w: int, c: int, k: int = 3,
           stride: int = 1) -> LayerSpec:
    oh, ow = h // stride, w // stride
    return LayerSpec(
        name, LayerKind.DWCONV,
        (GemmDims(M=oh * ow, N=1, K=k * k, reps=c, b_reused=False),),
        input_bytes=h * w * c * EB, output_bytes=oh * ow * c * EB,
        weight_bytes=k * k * c * EB, elem_bytes=EB)


def fc(name: str, m: int, k: int, n: int) -> LayerSpec:
    return LayerSpec(
        name, LayerKind.GEMM, (GemmDims(M=m, N=n, K=k),),
        input_bytes=m * k * EB, output_bytes=m * n * EB,
        weight_bytes=k * n * EB, elem_bytes=EB)


def attention(name: str, seq: int, d: int, heads: int) -> List[LayerSpec]:
    hd = d // heads
    return [
        fc(f"{name}.qkv", seq, d, 3 * d),
        LayerSpec(f"{name}.scores", LayerKind.ATTN,
                  (GemmDims(M=seq, N=seq, K=hd, reps=heads, b_reused=False),),
                  input_bytes=2 * seq * d * EB, output_bytes=heads * seq * seq * EB,
                  weight_bytes=0, elem_bytes=EB),
        LayerSpec(f"{name}.attnv", LayerKind.ATTN,
                  (GemmDims(M=seq, N=hd, K=seq, reps=heads, b_reused=False),),
                  input_bytes=(heads * seq * seq + seq * d) * EB,
                  output_bytes=seq * d * EB, weight_bytes=0, elem_bytes=EB),
        fc(f"{name}.proj", seq, d, d),
    ]


def transformer_layer(name: str, seq: int, d: int, heads: int,
                      d_ff: int) -> List[LayerSpec]:
    return attention(name, seq, d, heads) + [
        fc(f"{name}.ffn1", seq, d, d_ff),
        fc(f"{name}.ffn2", seq, d_ff, d),
    ]


def lstm_layer(name: str, seq: int, hidden: int) -> LayerSpec:
    # 4 gates; input = [x; h] of 2*hidden; B reused across all timesteps
    return LayerSpec(
        name, LayerKind.LSTM,
        (GemmDims(M=1, N=4 * hidden, K=2 * hidden, reps=seq, b_reused=True),),
        input_bytes=seq * hidden * EB, output_bytes=seq * hidden * EB,
        weight_bytes=2 * hidden * 4 * hidden * EB, elem_bytes=EB)


# ---------------------------------------------------------------------------
def resnet50() -> ModelGraph:
    L: List[LayerSpec] = [conv("conv1", 224, 224, 3, 64, k=7, stride=2)]
    stages = [  # (blocks, h, cin_mid, cout, stride_first)
        (3, 56, 64, 256, 1), (4, 56, 128, 512, 2),
        (6, 28, 256, 1024, 2), (3, 14, 512, 2048, 2)]
    cin = 64
    for si, (blocks, h, cmid, cout, s0) in enumerate(stages):
        for b in range(blocks):
            s = s0 if b == 0 else 1
            hh = h if b == 0 else h // s0
            L += [conv(f"s{si}b{b}.c1", hh, hh, cin, cmid, k=1, stride=s),
                  conv(f"s{si}b{b}.c2", hh // s, hh // s, cmid, cmid, k=3),
                  conv(f"s{si}b{b}.c3", hh // s, hh // s, cmid, cout, k=1)]
            cin = cout
    L.append(fc("fc", 1, 2048, 1000))
    return ModelGraph("resnet50", L, qos_ms=6.7)


def mobilenet_v2() -> ModelGraph:
    cfg = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
           (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    L: List[LayerSpec] = [conv("stem", 224, 224, 3, 32, k=3, stride=2)]
    h, cin = 112, 32
    for bi, (t, c, n, s) in enumerate(cfg):
        for i in range(n):
            stride = s if i == 0 else 1
            hid = cin * t
            if t != 1:
                L.append(conv(f"b{bi}.{i}.exp", h, h, cin, hid, k=1))
            L.append(dwconv(f"b{bi}.{i}.dw", h, h, hid, k=3, stride=stride))
            h = h // stride
            L.append(conv(f"b{bi}.{i}.prj", h, h, hid, c, k=1))
            cin = c
    L += [conv("head", h, h, cin, 1280, k=1), fc("fc", 1, 1280, 1000)]
    return ModelGraph("mobilenet_v2", L, qos_ms=2.8)


def efficientnet_b0() -> ModelGraph:
    cfg = [(1, 16, 1, 1, 3), (6, 24, 2, 2, 3), (6, 40, 2, 2, 5),
           (6, 80, 3, 2, 3), (6, 112, 3, 1, 5), (6, 192, 4, 2, 5),
           (6, 320, 1, 1, 3)]
    L: List[LayerSpec] = [conv("stem", 224, 224, 3, 32, k=3, stride=2)]
    h, cin = 112, 32
    for bi, (t, c, n, s, k) in enumerate(cfg):
        for i in range(n):
            stride = s if i == 0 else 1
            hid = cin * t
            if t != 1:
                L.append(conv(f"mb{bi}.{i}.exp", h, h, cin, hid, k=1))
            L.append(dwconv(f"mb{bi}.{i}.dw", h, h, hid, k=k, stride=stride))
            h = h // stride
            L.append(conv(f"mb{bi}.{i}.prj", h, h, hid, c, k=1))
            cin = c
    L += [conv("head", h, h, cin, 1280, k=1), fc("fc", 1, 1280, 1000)]
    return ModelGraph("efficientnet_b0", L, qos_ms=2.8)


def vit_base16() -> ModelGraph:
    seq, d, heads, dff = 197, 768, 12, 3072
    L: List[LayerSpec] = [conv("patch", 224, 224, 3, d, k=16, stride=16)]
    for i in range(12):
        L += transformer_layer(f"blk{i}", seq, d, heads, dff)
    L.append(fc("head", 1, d, 1000))
    return ModelGraph("vit_base16", L, qos_ms=40.0)


def bert_base(seq: int = 128) -> ModelGraph:
    d, heads, dff = 768, 12, 3072
    L: List[LayerSpec] = [fc("embed", seq, 1, d)]  # lookup modeled as stream
    for i in range(12):
        L += transformer_layer(f"blk{i}", seq, d, heads, dff)
    L.append(fc("pooler", 1, d, d))
    return ModelGraph("bert_base", L, qos_ms=40.0)


def gnmt(seq: int = 32, hidden: int = 1024) -> ModelGraph:
    L: List[LayerSpec] = []
    for i in range(4):
        L.append(lstm_layer(f"enc{i}", seq, hidden))
    for i in range(4):
        L.append(lstm_layer(f"dec{i}", seq, hidden))
    L.append(fc("softmax_proj", seq, hidden, 32000))
    return ModelGraph("gnmt", L, qos_ms=6.7)


def wav2vec2_base(seq: int = 250) -> ModelGraph:
    # conv feature extractor: 7 conv1d layers, 512 channels
    L: List[LayerSpec] = []
    t, cin = seq * 320, 1
    for i, (k, s) in enumerate([(10, 5), (3, 2), (3, 2), (3, 2), (3, 2), (2, 2), (2, 2)]):
        cout = 512
        t = t // s
        L.append(LayerSpec(
            f"feat{i}", LayerKind.GEMM,
            (GemmDims(M=t, N=cout, K=k * cin),),
            input_bytes=t * s * cin * EB, output_bytes=t * cout * EB,
            weight_bytes=k * cin * cout * EB, elem_bytes=EB))
        cin = cout
    for i in range(12):
        L += transformer_layer(f"blk{i}", seq, 768, 12, 3072)
    return ModelGraph("wav2vec2_base", L, qos_ms=16.7)


def pointpillars() -> ModelGraph:
    # PFN: 12k pillars x 100 pts x 9 feats -> 64; then 2D CNN backbone
    L: List[LayerSpec] = [
        fc("pfn", 12000 * 20, 9, 64),
    ]
    h, w = 496, 432
    cfg = [(4, 64, 2), (6, 128, 2), (6, 256, 2)]
    cin = 64
    for bi, (n, c, s) in enumerate(cfg):
        for i in range(n):
            stride = s if i == 0 else 1
            L.append(conv(f"bb{bi}.{i}", h, w, cin, c, k=3, stride=stride))
            if i == 0:
                h, w = h // s, w // s
            cin = c
    L.append(conv("head", h, w, 256, 2 + 4 + 2, k=1))  # cls+box+dir (approx)
    return ModelGraph("pointpillars", L, qos_ms=100.0)


BENCHMARKS: Dict[str, ModelGraph] = {}


def benchmark_models() -> Dict[str, ModelGraph]:
    global BENCHMARKS
    if not BENCHMARKS:
        BENCHMARKS = {
            "RS": resnet50(), "MB": mobilenet_v2(), "EF": efficientnet_b0(),
            "VT": vit_base16(), "BE": bert_base(), "GN": gnmt(),
            "WV": wav2vec2_base(), "PP": pointpillars(),
        }
    return BENCHMARKS
