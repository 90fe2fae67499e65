"""Measured wire transport for federated adapter exchange (port of
``repro.core.runtime.transport``).

The analytic cost model in :mod:`repro_torch.core.costs` counts
*parameters*; this module puts actual **bytes** on a simulated wire so the
two can be cross-checked per round:

* :class:`Codec` — array serialization: ``fp32`` (an exact cast) and
  ``bf16`` (round to nearest even, the paper's 2-byte accounting); ``int8``
  waits for a later slice;
* :class:`AdapterPayload` — one serialized adapter tree: per-leaf encoded
  blocks with CRC-32 checksums (out of band: they do not count as wire
  bytes) and the measured byte total.  Downlinks honour the recorded
  per-layer ranks: a rank-``p_l`` layer ships only its first ``p_l``
  rows/columns, so zero padding never travels;
* :class:`Transport` — encode → count bytes → decode.  What the receiving
  side uses is the decoded tree (host numpy leaves), as in the reference:
  clients resume from the decoded broadcast, and merge-into-base methods
  (FLoRA) fold the decoded stack into the base.  Per-client methods
  (FlexLoRA) ship each client's own tree.

``scale`` never travels: it is an O(L) header re-derived locally.  Local
DP on the uplink and the fault plan's retries are not ported yet.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core.aggregators.base import (adapter_leaf_paths,
                                               default_wire_arrays, get_path,
                                               set_path)

#: rank axis of each wire tensor (A: rows are rank, B: columns are rank)
_RANK_AXIS = {"A": -2, "B": -1}


class PayloadError(ValueError):
    """A received payload violates the structural contract (shape, layer
    count, rank bound, or undecodable bytes) for the tree it targets."""


class PayloadCorrupted(PayloadError):
    """A received block's bytes do not match its CRC-32 checksum."""


@dataclasses.dataclass
class EncodedArray:
    """One serialized tensor: raw payload, its shape, and a CRC-32 of the
    payload (not counted in ``num_bytes``)."""
    data: bytes
    shape: Tuple[int, ...]
    crc: Optional[int] = None

    @property
    def num_bytes(self) -> int:
        return len(self.data)

    def verify(self) -> None:
        if self.crc is not None and zlib.crc32(self.data) != self.crc:
            raise PayloadCorrupted(
                f"checksum mismatch on block shape={self.shape}: "
                f"crc32={zlib.crc32(self.data):#010x} != {self.crc:#010x}")


class Codec:
    """Array serializer.  ``decode(encode(x))`` returns fp32 numpy."""

    name: str = "?"
    bytes_per_param: float = 4.0

    def encode(self, arr: Any) -> EncodedArray:
        raise NotImplementedError

    def decode(self, enc: EncodedArray) -> np.ndarray:
        raise NotImplementedError


class Fp32Codec(Codec):
    """Exact for fp32 inputs: the round trip is the identity."""
    name = "fp32"

    def encode(self, arr) -> EncodedArray:
        a = np.asarray(arr, np.float32)
        return EncodedArray(a.tobytes(), a.shape)

    def decode(self, enc: EncodedArray) -> np.ndarray:
        # a writable copy: torch tensors are made from the decoded leaves
        return np.frombuffer(enc.data, np.float32).reshape(enc.shape).copy()


class Bf16Codec(Codec):
    """Cast to bfloat16, rounding to nearest even (the paper's 2-byte
    accounting).  The bytes equal the reference's ``ml_dtypes`` cast bit
    for bit, NaN included (a quiet NaN that keeps its sign)."""
    name = "bf16"
    bytes_per_param = 2.0

    def encode(self, arr) -> EncodedArray:
        a = np.ascontiguousarray(arr, np.float32)
        bits = torch.from_numpy(a).to(torch.bfloat16).view(torch.int16) \
            .numpy().view(np.uint16)
        nan = np.isnan(a)
        if nan.any():
            bits = np.where(nan, (a.view(np.uint32) >> 16 & 0x8000) | 0x7FC0,
                            bits).astype(np.uint16)
        return EncodedArray(bits.tobytes(), a.shape)

    def decode(self, enc: EncodedArray) -> np.ndarray:
        bits = np.frombuffer(enc.data, np.uint16).reshape(enc.shape)
        return (bits.astype(np.uint32) << 16).view(np.float32)


_CODECS = {"fp32": Fp32Codec, "bf16": Bf16Codec}


def make_codec(name: str) -> Codec:
    if name == "int8":
        raise NotImplementedError(
            "codec 'int8' is not ported yet (the wire-codecs-and-DP slice "
            "of the port); use 'fp32' or 'bf16'")
    try:
        return _CODECS[name]()
    except KeyError:
        raise ValueError(f"unknown codec {name!r} "
                         f"(registered: {sorted(_CODECS)})") from None


def available_codecs() -> List[str]:
    return sorted(_CODECS)


def _host(arr: Any) -> np.ndarray:
    if isinstance(arr, torch.Tensor):
        return arr.detach().float().cpu().numpy()
    return np.asarray(arr)


def _wire_fn(aggregator) -> Any:
    return getattr(aggregator, "wire_arrays", None) or default_wire_arrays


@dataclasses.dataclass
class AdapterPayload:
    """One adapter tree as it travels: leaf path → wire-array name →
    per-layer :class:`EncodedArray` list (one whole-array block when no
    ragged per-layer ranks were given)."""

    codec: str
    blocks: Dict[Tuple, Dict[str, List[EncodedArray]]]
    num_bytes: int

    @classmethod
    def pack(cls, tree: Dict, codec: Codec, wire_fn=default_wire_arrays,
             ranks: Optional[Dict[Tuple, Sequence[int]]] = None
             ) -> "AdapterPayload":
        """Serialize ``tree``'s wire arrays, each block with its CRC-32.
        With ``ranks`` (per leaf, per layer, as recorded in an
        ``AggResult``), layer ``l`` of a leaf ships only its first ``r_l``
        rank rows/columns."""
        blocks: Dict[Tuple, Dict[str, List[EncodedArray]]] = {}
        total = 0
        for path in adapter_leaf_paths(tree):
            for name, arr in wire_fn(get_path(tree, path)).items():
                arr = _host(arr)
                axis = _RANK_AXIS.get(name)
                rs = ranks.get(path) if ranks else None
                if rs is None or axis is None:
                    encs = [codec.encode(arr)]
                else:
                    layers = arr if arr.ndim == 3 else arr[None]
                    encs = [codec.encode(lay[:r_l, :] if axis == -2
                                         else lay[:, :r_l])
                            for lay, r_l in zip(layers, rs)]
                encs = [dataclasses.replace(e, crc=zlib.crc32(e.data))
                        for e in encs]
                blocks.setdefault(path, {})[name] = encs
                total += sum(e.num_bytes for e in encs)
        return cls(codec.name, blocks, total)

    def unpack_into(self, tree: Dict, codec: Codec) -> Dict:
        """A tree shaped like ``tree`` with every wire array replaced by its
        decoded bytes (numpy, on the host); non-wire entries (``scale``, a
        frozen FFA ``A``) pass through from ``tree``.  Every block's CRC-32 is checked and
        the decoded shapes are held to ``tree``'s: ragged per-layer blocks
        must cover every layer with ranks within the reference rank
        dimension."""
        out: Dict = {}
        for path in adapter_leaf_paths(tree):
            leaf = dict(get_path(tree, path))
            for name, encs in self.blocks[path].items():
                ref_shape = tuple(leaf[name].shape)
                for enc in encs:
                    enc.verify()
                if len(encs) == 1 and encs[0].shape == ref_shape:
                    leaf[name] = _checked_decode(codec, encs[0], path, name)
                    continue
                axis = _RANK_AXIS.get(name)
                if axis is None:
                    raise PayloadError(f"{_where(path, name)}: ragged blocks "
                                       "for a non-rank wire array")
                full = ref_shape if len(ref_shape) == 3 else (1,) + ref_shape
                if len(encs) != full[0]:
                    raise PayloadError(f"{_where(path, name)}: {len(encs)} "
                                       f"ragged layer blocks for {full[0]} layers")
                layers = np.zeros(full, np.float32)
                for l, enc in enumerate(encs):
                    dec = _checked_decode(codec, enc, path, name)
                    _check_ragged(dec, full[1:], axis, path, name, l)
                    if axis == -2:
                        layers[l, :dec.shape[0], :] = dec
                    else:
                        layers[l, :, :dec.shape[1]] = dec
                leaf[name] = layers if len(ref_shape) == 3 else layers[0]
            set_path(out, path, leaf)
        return out


def _where(path: Tuple, name: str) -> str:
    return f"{'/'.join(map(str, path))}:{name}"


def _checked_decode(codec: Codec, enc: EncodedArray, path: Tuple,
                    name: str) -> np.ndarray:
    try:
        dec = codec.decode(enc)
    except (ValueError, TypeError) as e:
        raise PayloadError(f"{_where(path, name)}: undecodable block: {e}") from e
    if tuple(dec.shape) != tuple(enc.shape):
        raise PayloadError(f"{_where(path, name)}: decoded shape {dec.shape} "
                           f"!= header {enc.shape}")
    return dec


def _check_ragged(dec: np.ndarray, layer_shape: Tuple[int, ...], axis: int,
                  path: Tuple, name: str, layer: int) -> None:
    """One ragged layer block: the reference layer shape with the rank axis
    shortened to r_l ≤ full rank."""
    full = list(layer_shape)
    got = list(dec.shape)
    ok = (len(got) == len(full) and got[axis] <= full[axis]
          and all(g == f for i, (g, f) in enumerate(zip(got, full))
                  if i != len(full) + axis))
    if not ok:
        raise PayloadError(
            f"{_where(path, name)}[{layer}]: ragged block shape "
            f"{tuple(dec.shape)} violates layer contract {tuple(layer_shape)} "
            f"(rank axis {axis} ≤ {full[axis]})")


class Transport:
    """Measured client↔server wire: every exchanged adapter tree is
    serialized with the codec, its bytes are counted, and the decoded tree
    is what the receiving side uses."""

    def __init__(self, codec: Any = "fp32"):
        self.codec = codec if isinstance(codec, Codec) else make_codec(codec)

    def client_to_server(self, adapters: Dict, aggregator) -> Tuple[Dict, int]:
        """Uplink one trained client tree.  Returns (decoded tree, bytes)."""
        payload = AdapterPayload.pack(adapters, self.codec, _wire_fn(aggregator))
        return payload.unpack_into(adapters, self.codec), payload.num_bytes

    def server_to_clients(self, agg, aggregator, num_receivers: int
                          ) -> Tuple[Optional[Dict], int]:
        """Downlink one round's result to ``num_receivers`` clients.

        Broadcast methods ship the global tree (ragged per-layer ranks:
        zero padding stays home) once per receiver; per-client methods
        (FlexLoRA) ship each tailored tree once.  Returns the decoded global
        tree (what clients resume from; ``None`` without one) and the total
        downlink bytes."""
        wire = _wire_fn(aggregator)
        if agg.per_client is not None:
            nbytes = sum(AdapterPayload.pack(t, self.codec, wire).num_bytes
                         for t in agg.per_client)
            if agg.global_adapters is None:
                return None, nbytes
            payload = AdapterPayload.pack(agg.global_adapters, self.codec, wire)
            return payload.unpack_into(agg.global_adapters, self.codec), nbytes
        if agg.global_adapters is None:
            return None, 0
        payload = AdapterPayload.pack(agg.global_adapters, self.codec, wire,
                                      ranks=agg.ranks)
        decoded = payload.unpack_into(agg.global_adapters, self.codec)
        return decoded, payload.num_bytes * num_receivers


def make_transport(spec: Any) -> Transport:
    """A transport from an instance (returned as is) or a codec name."""
    if isinstance(spec, Transport):
        return spec
    return Transport(spec or "fp32")
