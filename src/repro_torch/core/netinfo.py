"""Network descriptions for the port: ``LayerInfo``, ``NetInfo``, the
``_B`` builder and the paper's VGG workloads.

A line-for-line copy of the VGG part of ``repro/core/netinfo.py`` (the
JAX package's model/HW analysis), kept here so that the port imports
nothing of ``repro``; layer lists and ``macs`` agree with it exactly
(``tests/test_torch_cnn.py`` checks this).

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
