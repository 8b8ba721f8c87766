"""KV-cache precision specs (DESIGN.md §14).

One `KVPrecision` dataclass unifies what used to be two unrelated knobs:
`ModelConfig.cache_dtype` (a raw storage cast applied by the attention
layer) and the page-table `precision` tag
(`cache.paged.PageEntry.precision`). A spec names

  * the storage dtype ("" = native compute dtype),
  * the scale granularity ("none" = an unscaled cast, "token_head" =
    symmetric per-token-per-head scales held next to the page/cache), and
  * the chunked-prefill staging policy ("auto" = stage the in-flight
    prompt in a native-dtype buffer whenever storage is lossy).

Dtypes are strings here: the module is pure Python, the reference
package's own copy for the port. The port resolves a spec with
``resolve_kv_precision``; ``repro_torch.kernels.quant`` maps a quantized
spec to its torch dtype.

The legacy ``cache_dtype`` field keeps working through
:func:`resolve_kv_precision` (mapped to a ``granularity="none"`` cast)
but emits a ``DeprecationWarning`` once per dtype.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

__all__ = ["KVPrecision", "parse_kv_precision", "resolve_kv_precision"]

# quantized storage dtypes -> symmetric clip range of the format
_QMAX = {"int8": 127.0, "float8_e4m3fn": 448.0}

# launcher-friendly aliases accepted by parse_kv_precision
_ALIASES = {"native": "", "fp8": "float8_e4m3fn"}

_SCALE_BYTES = 4  # scales are always float32


@dataclasses.dataclass(frozen=True)
class KVPrecision:
    """How K/V pages are stored. Frozen + hashable: specs ride inside
    ``ModelConfig`` as their string form."""

    dtype: str = ""            # "" = native compute dtype
    granularity: str = "none"  # "none" (cast) | "token_head" (scaled)
    staging: str = "auto"      # "auto" | "off" — chunked native staging

    def __post_init__(self):
        if self.granularity not in ("none", "token_head"):
            raise ValueError(f"unknown scale granularity {self.granularity!r}")
        if self.staging not in ("auto", "off"):
            raise ValueError(f"unknown staging policy {self.staging!r}")
        if self.granularity == "token_head" and self.dtype not in _QMAX:
            raise ValueError(
                f"scaled storage needs a quantized dtype, got {self.dtype!r}")

    # ------------------------------------------------------------- kind
    @property
    def is_native(self) -> bool:
        return self.dtype == ""

    @property
    def is_quantized(self) -> bool:
        """Scaled integer/fp8 storage (dequant needs the scale table)."""
        return self.granularity == "token_head"

    @property
    def is_cast(self) -> bool:
        """Legacy unscaled storage cast (the old ``cache_dtype``)."""
        return self.dtype != "" and self.granularity == "none"

    @property
    def lossy(self) -> bool:
        """Does a cache round-trip lose bits vs the compute dtype? Casts
        are treated as lossy (float16 storage under float32 compute is);
        the chunked staging buffer exists exactly when this is True."""
        return self.dtype != ""

    @property
    def qmax(self) -> float:
        return _QMAX[self.dtype]

    @property
    def tag(self) -> str:
        """The page-table precision tag (``PageEntry.precision``)."""
        return "native" if self.is_native else self.dtype

    # ------------------------------------------------------------ bytes
    def token_bytes(self, head_dim: int, native_bytes: int = 4) -> int:
        """Storage bytes per cached token per KV head (K or V alone) —
        the quantity the equal-bytes capacity bench holds constant."""
        if self.is_native:
            return head_dim * native_bytes
        if self.is_quantized:
            itemsize = 1  # int8 and fp8 are both one byte
            return head_dim * itemsize + _SCALE_BYTES
        return head_dim * _cast_bytes(self.dtype, native_bytes)

    def page_bytes(self, page_size: int, kv_heads: int, head_dim: int,
                   native_bytes: int = 4) -> int:
        """Bytes of one K/V page pair at this precision."""
        return 2 * page_size * kv_heads * self.token_bytes(head_dim,
                                                           native_bytes)


def _cast_bytes(dtype: str, native_bytes: int) -> int:
    for n in (2, 4, 8):
        if str(n * 8) in dtype:
            return n
    return native_bytes


def parse_kv_precision(spec) -> KVPrecision:
    """Parse a launcher/config spec: "native"/"" | "int8" | "fp8" |
    any raw dtype string (legacy cast) | an existing KVPrecision."""
    if isinstance(spec, KVPrecision):
        return spec
    s = _ALIASES.get(spec, spec)
    if s == "":
        return KVPrecision()
    if s in _QMAX:
        return KVPrecision(dtype=s, granularity="token_head")
    return KVPrecision(dtype=s, granularity="none")


_warned: set = set()


def resolve_kv_precision(kv_precision: str = "",
                         cache_dtype: str = "") -> KVPrecision:
    """The one resolution order: explicit ``kv_precision`` wins; a bare
    legacy ``cache_dtype`` still works as an unscaled cast but warns."""
    if kv_precision:
        return parse_kv_precision(kv_precision)
    if cache_dtype:
        if cache_dtype not in _warned:
            _warned.add(cache_dtype)
            warnings.warn(
                "ModelConfig.cache_dtype is deprecated; use "
                f"kv_precision={cache_dtype!r} (KVPrecision spec) instead",
                DeprecationWarning, stacklevel=3)
        return KVPrecision(dtype=cache_dtype, granularity="none")
    return KVPrecision()
