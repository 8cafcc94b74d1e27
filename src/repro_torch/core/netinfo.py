"""Network descriptions for the port: ``LayerInfo``, ``NetInfo``, the
``_B`` builder and the paper's workloads (the VGG family and the other
networks of its Table 1, ``TABLE1_NETS``, and its input cases,
``INPUT_CASES``).

A line-for-line copy of ``repro/core/netinfo.py`` (the JAX package's
model/HW analysis), kept here so that the port imports nothing of
``repro``; layer lists and ``macs`` agree with it exactly
(``tests/test_torch_cnn.py`` checks VGG, ``tests/test_torch_netinfo_table.py``
every net of the table).

Conventions
-----------
* 1 MAC = 2 ops; ``ops`` counts ops (so GOP/s figures match the paper).
* ``*_bytes`` are *external-memory* traffic for one inference at the given
  data/weight bit-widths (weights + input fm + output fm), the denominator
  of the CTC ratio (Fig. 1).
* Feature maps are NCHW; convs are 'same'-padded unless a stride is given.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

# ---------------------------------------------------------------------------
# Layer description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LayerInfo:
    """One *major* layer (CONV / FC / POOL / DWCONV); BN/activation are fused."""

    name: str
    kind: str  # conv | dwconv | fc | pool
    h: int  # output height
    w: int  # output width
    c: int  # input channels
    k: int  # output channels
    r: int = 1  # kernel height
    s: int = 1  # kernel width
    stride: int = 1
    groups: int = 1

    # -- computation -------------------------------------------------------
    @property
    def macs(self) -> int:
        if self.kind == "pool":
            return 0
        return self.h * self.w * self.r * self.s * (self.c // self.groups) * self.k

    @property
    def ops(self) -> int:
        return 2 * self.macs

    # -- memory ------------------------------------------------------------
    def weight_bytes(self, ww_bits: int = 16) -> int:
        if self.kind == "pool":
            return 0
        n = self.r * self.s * (self.c // self.groups) * self.k
        return (n * ww_bits) // 8

    def ifm_bytes(self, dw_bits: int = 16) -> int:
        ih, iw = self.h * self.stride, self.w * self.stride
        return (ih * iw * self.c * dw_bits) // 8

    def ofm_bytes(self, dw_bits: int = 16) -> int:
        return (self.h * self.w * self.k * dw_bits) // 8

    def total_bytes(self, dw_bits: int = 16, ww_bits: int = 16) -> int:
        return self.weight_bytes(ww_bits) + self.ifm_bytes(dw_bits) + self.ofm_bytes(dw_bits)

    def ctc(self, dw_bits: int = 16, ww_bits: int = 16) -> float:
        """Computation-to-communication ratio (the paper's *computation
        reuse factor*, Alg. 2 line 3): ops per byte of weights fetched.

        In the DNNBuilder-style dataflow feature maps stream on-chip between
        stages, so external traffic is the weight stream — this is why the
        paper's Fig. 1 CTC medians scale exactly with input area (256x from
        32x32 to 512x512: ops scale with H*W, weights are constant)."""
        b = self.weight_bytes(ww_bits)
        return self.ops / b if b else 0.0


@dataclasses.dataclass(frozen=True)
class NetInfo:
    name: str
    input_hw: tuple[int, int]
    input_c: int
    layers: tuple[LayerInfo, ...]

    @property
    def major_layers(self) -> tuple[LayerInfo, ...]:
        """Layers that get pipeline stages / generic passes (convs + fc)."""
        return tuple(l for l in self.layers if l.kind != "pool")

    @property
    def major_indices(self) -> tuple[int, ...]:
        """Index into ``layers`` of each major layer. The generic segment
        for split point ``sp`` is exactly ``layers[major_indices[sp]:]``
        (pools trailing major layers <= sp are fused into their stage) —
        :mod:`repro.core.layer_arrays` keys its packed segments on this."""
        return tuple(i for i, l in enumerate(self.layers) if l.kind != "pool")

    @property
    def total_ops(self) -> int:
        return sum(l.ops for l in self.layers)

    def ctc_list(self, dw: int = 16, ww: int = 16) -> list[float]:
        return [l.ctc(dw, ww) for l in self.major_layers]

    def half_variance_ratio(self, dw: int = 16, ww: int = 16) -> float:
        """Table 1: CTC variance of the first half (50% of MACs) over the second."""
        layers = self.major_layers
        total = sum(l.macs for l in layers)
        acc, split = 0, len(layers)
        for i, l in enumerate(layers):
            acc += l.macs
            if acc >= total / 2:
                split = i + 1
                break
        first = [l.ctc(dw, ww) for l in layers[:split]]
        second = [l.ctc(dw, ww) for l in layers[split:]]

        def var(xs: list[float]) -> float:
            if not xs:
                return 0.0
            m = sum(xs) / len(xs)
            return sum((x - m) ** 2 for x in xs) / len(xs)

        v1, v2 = var(first), var(second)
        return v1 / v2 if v2 else float("inf")


# ---------------------------------------------------------------------------
# Builder: tracks fm size while appending layers
# ---------------------------------------------------------------------------


class _B:
    def __init__(self, name: str, h: int, w: int, c: int):
        self.name, self.h, self.w, self.c = name, h, w, c
        self.layers: list[LayerInfo] = []
        self._n = 0
        self._ih, self._iw, self._ic = h, w, c

    def conv(self, k: int, r: int, s: int | None = None, stride: int = 1, groups: int = 1):
        s = r if s is None else s
        oh, ow = -(-self.h // stride), -(-self.w // stride)
        self._n += 1
        self.layers.append(
            LayerInfo(f"conv{self._n}", "conv" if groups == 1 else "dwconv",
                      oh, ow, self.c, k, r, s, stride, groups))
        self.h, self.w, self.c = oh, ow, k
        return self

    def dwconv(self, r: int, stride: int = 1):
        """Depthwise conv: groups == channels."""
        oh, ow = -(-self.h // stride), -(-self.w // stride)
        self._n += 1
        self.layers.append(
            LayerInfo(f"dw{self._n}", "dwconv", oh, ow, self.c, self.c, r, r, stride, self.c))
        self.h, self.w = oh, ow
        return self

    def pool(self, r: int = 2, stride: int | None = None):
        stride = r if stride is None else stride
        oh, ow = self.h // stride, self.w // stride
        self._n += 1
        self.layers.append(LayerInfo(f"pool{self._n}", "pool", oh, ow, self.c, self.c, r, r, stride))
        self.h, self.w = oh, ow
        return self

    def gap(self):
        self._n += 1
        self.layers.append(LayerInfo(f"gap{self._n}", "pool", 1, 1, self.c, self.c, self.h, self.w, 1))
        self.h = self.w = 1
        return self

    def fc(self, k: int):
        self._n += 1
        cin = self.h * self.w * self.c
        self.layers.append(LayerInfo(f"fc{self._n}", "fc", 1, 1, cin, k))
        self.h = self.w = 1
        self.c = k
        return self

    def done(self) -> NetInfo:
        return NetInfo(self.name, (self._ih, self._iw), self._ic, tuple(self.layers))


# ---------------------------------------------------------------------------
# The paper's workloads
# ---------------------------------------------------------------------------


def vgg16(h: int = 224, w: int | None = None, with_fc: bool = False,
          extra_per_group: int = 0) -> NetInfo:
    """VGG-16 (conv part). ``extra_per_group`` adds N convs to each of the 5
    groups — the paper's 18/28/38-layer VGG-like DNNs (Sec. 8.2)."""
    w = h if w is None else w
    n_layers = 13 + 5 * extra_per_group
    b = _B(f"vgg{n_layers}_{h}x{w}", h, w, 3)
    for k, reps in [(64, 2), (128, 2), (256, 3), (512, 3), (512, 3)]:
        for _ in range(reps + extra_per_group):
            b.conv(k, 3)
        b.pool(2)
    if with_fc:
        b.fc(4096).fc(4096).fc(1000)
    return b.done()


def vgg19(h: int = 224, w: int | None = None, with_fc: bool = True) -> NetInfo:
    w = h if w is None else w
    b = _B(f"vgg19_{h}x{w}", h, w, 3)
    for k, reps in [(64, 2), (128, 2), (256, 4), (512, 4), (512, 4)]:
        for _ in range(reps):
            b.conv(k, 3)
        b.pool(2)
    if with_fc:
        b.fc(4096).fc(4096).fc(1000)
    return b.done()


def alexnet() -> NetInfo:
    b = _B("alexnet", 227, 227, 3)
    b.conv(96, 11, stride=4).pool(3, 2)
    b.conv(256, 5).pool(3, 2)
    b.conv(384, 3).conv(384, 3).conv(256, 3).pool(3, 2)
    b.fc(4096).fc(4096).fc(1000)
    return b.done()


def _inception_a(b: _B, n1: int, n3r: int, n3: int, n5r: int, n5: int, pp: int):
    """GoogLeNet inception module: four parallel branches, concatenated.

    Modelled as sequential layers sharing the same input fm (CTC analysis
    only cares about per-layer shapes, not the dataflow graph)."""
    h, w, c = b.h, b.w, b.c
    outs = []
    for cin, k, r in [(c, n1, 1), (c, n3r, 1), (n3r, n3, 3), (c, n5r, 1), (n5r, n5, 5), (c, pp, 1)]:
        if k == 0:
            continue
        b._n += 1
        b.layers.append(LayerInfo(f"conv{b._n}", "conv", h, w, cin, k, r, r, 1))
        outs.append(k)
    b.c = n1 + n3 + n5 + pp


def googlenet() -> NetInfo:
    b = _B("googlenet", 224, 224, 3)
    b.conv(64, 7, stride=2).pool(3, 2).conv(64, 1).conv(192, 3).pool(3, 2)
    _inception_a(b, 64, 96, 128, 16, 32, 32)
    _inception_a(b, 128, 128, 192, 32, 96, 64)
    b.pool(3, 2)
    _inception_a(b, 192, 96, 208, 16, 48, 64)
    _inception_a(b, 160, 112, 224, 24, 64, 64)
    _inception_a(b, 128, 128, 256, 24, 64, 64)
    _inception_a(b, 112, 144, 288, 32, 64, 64)
    _inception_a(b, 256, 160, 320, 32, 128, 128)
    b.pool(3, 2)
    _inception_a(b, 256, 160, 320, 32, 128, 128)
    _inception_a(b, 384, 192, 384, 48, 128, 128)
    b.gap().fc(1000)
    return b.done()


def inception_v3() -> NetInfo:
    """InceptionV3 approximated with the standard published stem + 11 mixed
    blocks (branch convs flattened, factorized 7x1/1x7 kept)."""
    b = _B("inceptionv3", 299, 299, 3)
    b.conv(32, 3, stride=2).conv(32, 3).conv(64, 3).pool(3, 2)
    b.conv(80, 1).conv(192, 3).pool(3, 2)
    for pp in (32, 64, 64):  # 3x Mixed5 (35x35)
        _inception_a(b, 64, 48, 64, 64, 96, pp)
    b.pool(3, 2)  # grid reduction (approx)
    for _ in range(4):  # 4x Mixed6 (17x17), 7x7 factorized -> 7x1 + 1x7
        h, w, c = b.h, b.w, b.c
        for cin, k, r, s in [(c, 192, 1, 1), (c, 160, 1, 1), (160, 160, 1, 7),
                             (160, 192, 7, 1), (c, 160, 1, 1), (160, 160, 7, 1),
                             (160, 160, 1, 7), (160, 160, 7, 1), (160, 192, 1, 7),
                             (c, 192, 1, 1)]:
            b._n += 1
            b.layers.append(LayerInfo(f"conv{b._n}", "conv", h, w, cin, k, r, s, 1))
        b.c = 768
    b.pool(3, 2)
    for _ in range(2):  # 2x Mixed7 (8x8)
        h, w, c = b.h, b.w, b.c
        for cin, k, r, s in [(c, 320, 1, 1), (c, 384, 1, 1), (384, 384, 1, 3),
                             (384, 384, 3, 1), (c, 448, 1, 1), (448, 384, 3, 3),
                             (384, 384, 1, 3), (384, 384, 3, 1), (c, 192, 1, 1)]:
            b._n += 1
            b.layers.append(LayerInfo(f"conv{b._n}", "conv", h, w, cin, k, r, s, 1))
        b.c = 2048
    b.gap().fc(1000)
    return b.done()


def _res_basic(b: _B, k: int, stride: int = 1):
    b.conv(k, 3, stride=stride).conv(k, 3)
    if stride != 1:
        pass  # projection shortcut folded into the main convs for analysis


def _res_bottleneck(b: _B, k: int, stride: int = 1):
    b.conv(k, 1, stride=stride).conv(k, 3).conv(4 * k, 1)


def resnet18() -> NetInfo:
    b = _B("resnet18", 224, 224, 3)
    b.conv(64, 7, stride=2).pool(3, 2)
    for k, reps, s in [(64, 2, 1), (128, 2, 2), (256, 2, 2), (512, 2, 2)]:
        _res_basic(b, k, s)
        for _ in range(reps - 1):
            _res_basic(b, k)
    b.gap().fc(1000)
    return b.done()


def resnet50() -> NetInfo:
    b = _B("resnet50", 224, 224, 3)
    b.conv(64, 7, stride=2).pool(3, 2)
    for k, reps, s in [(64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)]:
        _res_bottleneck(b, k, s)
        for _ in range(reps - 1):
            _res_bottleneck(b, k)
    b.gap().fc(1000)
    return b.done()


def squeezenet() -> NetInfo:
    b = _B("squeezenet", 227, 227, 3)
    b.conv(96, 7, stride=2).pool(3, 2)
    fires = [(16, 64), (16, 64), (32, 128)]
    for s1, e in fires:
        b.conv(s1, 1).conv(e, 1).conv(e, 3)  # squeeze + expand1x1 + expand3x3
        b.c = 2 * e
    b.pool(3, 2)
    for s1, e in [(32, 128), (48, 192), (48, 192), (64, 256)]:
        b.conv(s1, 1).conv(e, 1).conv(e, 3)
        b.c = 2 * e
    b.pool(3, 2)
    b.conv(64, 1).conv(256, 1).conv(256, 3)
    b.c = 512
    b.conv(1000, 1).gap()
    return b.done()


def mobilenet() -> NetInfo:
    b = _B("mobilenet", 224, 224, 3)
    b.conv(32, 3, stride=2)
    plan = [(64, 1), (128, 2), (128, 1), (256, 2), (256, 1), (512, 2)] + \
        [(512, 1)] * 5 + [(1024, 2), (1024, 1)]
    for k, s in plan:
        b.dwconv(3, stride=s).conv(k, 1)
    b.gap().fc(1000)
    return b.done()


def mobilenet_v2() -> NetInfo:
    b = _B("mobilenetv2", 224, 224, 3)
    b.conv(32, 3, stride=2)
    # (expansion t, out c, repeats, stride)
    plan = [(1, 16, 1, 1), (6, 24, 2, 2), (6, 32, 3, 2), (6, 64, 4, 2),
            (6, 96, 3, 1), (6, 160, 3, 2), (6, 320, 1, 1)]
    for t, k, reps, s in plan:
        for i in range(reps):
            cin = b.c
            if t != 1:
                b.conv(cin * t, 1)
            b.dwconv(3, stride=s if i == 0 else 1)
            b.conv(k, 1)
    b.conv(1280, 1).gap().fc(1000)
    return b.done()


def yolo() -> NetInfo:
    """YOLOv1-tiny-like backbone used in the pipeline-model validation (Fig. 7)."""
    b = _B("yolo", 448, 448, 3)
    for k in (16, 32, 64, 128, 256, 512):
        b.conv(k, 3).pool(2)
    b.conv(1024, 3).conv(1024, 3).conv(1024, 3)
    return b.done()


def zfnet() -> NetInfo:
    b = _B("zf", 224, 224, 3)
    b.conv(96, 7, stride=2).pool(3, 2)
    b.conv(256, 5, stride=2).pool(3, 2)
    b.conv(384, 3).conv(384, 3).conv(256, 3).pool(3, 2)
    b.fc(4096).fc(4096).fc(1000)
    return b.done()


TABLE1_NETS: dict[str, Callable[[], NetInfo]] = {
    "alexnet": alexnet,
    "googlenet": googlenet,
    "inceptionv3": inception_v3,
    "vgg16": lambda: vgg16(224, with_fc=True),
    "vgg19": vgg19,
    "resnet18": resnet18,
    "resnet50": resnet50,
    "squeezenet": squeezenet,
    "mobilenet": mobilenet,
    "mobilenetv2": mobilenet_v2,
}

# The 12 input-resolution cases of Figs. 1/9/10 and Table 3.
INPUT_CASES: tuple[tuple[int, int], ...] = (
    (32, 32), (64, 64), (128, 128), (224, 224), (320, 320), (384, 384),
    (320, 480), (448, 448), (512, 512), (480, 800), (512, 1382), (720, 1280),
)
