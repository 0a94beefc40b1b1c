"""SSZ type system: basic types, collections, containers, unions.

Mirrors the surface of the reference's `consensus/ssz` + `ssz_types` +
`ssz_derive` crates (Lighthouse's consensus/ssz/src/{encode,decode}.rs,
consensus/ssz_types/src/{fixed_vector,variable_list,bitfield}.rs):
  * `Encode`/`Decode`            -> classmethods `encode` / `decode`
  * `#[derive(Encode, Decode)]`  -> `Container` with annotated fields
  * typenum lengths              -> parameterized types `Vector[T, N]`,
    `List[T, N]`, `Bitvector[N]`, `Bitlist[N]`, `ByteVector[N]`,
    `ByteList[N]` (cached subclasses)
  * `tree_hash::TreeHash`        -> classmethod `hash_tree_root`

Values are plain Python data (int / bool / bytes / list / Container);
types validate on construction (`coerce`) and decode defensively
(`DecodeError`), matching the reference's error-returning decoders.

NOTE: modules that *define* Containers (this one included) must not use
`from __future__ import annotations`: field discovery reads evaluated
class annotations.
"""
from typing import Any, Dict, Sequence, Tuple

from .hash import (
    BYTES_PER_CHUNK,
    merkleize,
    mix_in_length,
    mix_in_selector,
    next_pow_of_two,
    pack_bytes,
    pack_bytes_buf,
)

BYTES_PER_LENGTH_OFFSET = 4


class DecodeError(Exception):
    """Equivalent of ssz::DecodeError (consensus/ssz/src/decode.rs)."""


class SSZType:
    """Base: every SSZ type implements this classmethod surface."""

    @classmethod
    def is_fixed_size(cls) -> bool:
        raise NotImplementedError

    @classmethod
    def fixed_size(cls) -> int:
        raise NotImplementedError(f"{cls.__name__} is variable-size")

    @classmethod
    def coerce(cls, value):
        """Validate/normalize a value of this type (raise on invalid)."""
        raise NotImplementedError

    @classmethod
    def default(cls):
        raise NotImplementedError

    @classmethod
    def encode(cls, value) -> bytes:
        raise NotImplementedError

    @classmethod
    def decode(cls, data: bytes):
        raise NotImplementedError

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        raise NotImplementedError


# --- Basic types -------------------------------------------------------------


class _UIntMeta(type):
    def __repr__(cls):
        return cls.__name__


class _UInt(SSZType, metaclass=_UIntMeta):
    BITS: int = 0

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return cls.BITS // 8

    @classmethod
    def coerce(cls, value):
        v = int(value)
        if not 0 <= v < (1 << cls.BITS):
            raise ValueError(f"{v} out of range for {cls.__name__}")
        return v

    @classmethod
    def default(cls):
        return 0

    @classmethod
    def encode(cls, value) -> bytes:
        return int(value).to_bytes(cls.BITS // 8, "little")

    @classmethod
    def decode(cls, data: bytes):
        if len(data) != cls.BITS // 8:
            raise DecodeError(
                f"{cls.__name__}: expected {cls.BITS // 8} bytes, got {len(data)}"
            )
        return int.from_bytes(data, "little")

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return cls.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")


class uint8(_UInt):
    BITS = 8


class uint16(_UInt):
    BITS = 16


class uint32(_UInt):
    BITS = 32


class uint64(_UInt):
    BITS = 64


class uint128(_UInt):
    BITS = 128


class uint256(_UInt):
    BITS = 256


class boolean(SSZType):
    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return 1

    @classmethod
    def coerce(cls, value):
        if value in (0, 1, False, True):
            return bool(value)
        raise ValueError(f"not a boolean: {value!r}")

    @classmethod
    def default(cls):
        return False

    @classmethod
    def encode(cls, value) -> bytes:
        return b"\x01" if value else b"\x00"

    @classmethod
    def decode(cls, data: bytes):
        if data == b"\x00":
            return False
        if data == b"\x01":
            return True
        raise DecodeError(f"invalid boolean byte {data!r}")

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return cls.encode(value).ljust(BYTES_PER_CHUNK, b"\x00")


# --- Parameterized type machinery -------------------------------------------

_PARAM_CACHE: Dict[tuple, type] = {}


def _parametrize(base, key, make):
    full = (base, *key)
    if full not in _PARAM_CACHE:
        _PARAM_CACHE[full] = make()
    return _PARAM_CACHE[full]


# --- Byte collections --------------------------------------------------------


class ByteVector(SSZType):
    """bytes of exactly LENGTH (ssz_types::FixedVector<u8, N>, hashed as
    packed bytes).  Use ByteVector[N] or the Bytes* aliases."""

    LENGTH: int = 0

    def __class_getitem__(cls, n: int):
        def make():
            return type(f"ByteVector{n}", (ByteVector,), {"LENGTH": n})

        return _parametrize(ByteVector, (n,), make)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return cls.LENGTH

    @classmethod
    def coerce(cls, value):
        b = bytes(value)
        if len(b) != cls.LENGTH:
            raise ValueError(f"expected {cls.LENGTH} bytes, got {len(b)}")
        return b

    @classmethod
    def default(cls):
        return b"\x00" * cls.LENGTH

    @classmethod
    def encode(cls, value) -> bytes:
        return bytes(value)

    @classmethod
    def decode(cls, data: bytes):
        if len(data) != cls.LENGTH:
            raise DecodeError(
                f"ByteVector{cls.LENGTH}: got {len(data)} bytes"
            )
        return bytes(data)

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return merkleize(pack_bytes_buf(bytes(value)))


Bytes4 = ByteVector[4]
Bytes20 = ByteVector[20]
Bytes32 = ByteVector[32]
Bytes48 = ByteVector[48]
Bytes96 = ByteVector[96]


class ByteList(SSZType):
    """bytes of length <= LIMIT (ssz_types::VariableList<u8, N>)."""

    LIMIT: int = 0

    def __class_getitem__(cls, n: int):
        def make():
            return type(f"ByteList{n}", (ByteList,), {"LIMIT": n})

        return _parametrize(ByteList, (n,), make)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def coerce(cls, value):
        b = bytes(value)
        if len(b) > cls.LIMIT:
            raise ValueError(f"ByteList{cls.LIMIT}: {len(b)} bytes")
        return b

    @classmethod
    def default(cls):
        return b""

    @classmethod
    def encode(cls, value) -> bytes:
        return bytes(value)

    @classmethod
    def decode(cls, data: bytes):
        if len(data) > cls.LIMIT:
            raise DecodeError(f"ByteList{cls.LIMIT}: got {len(data)} bytes")
        return bytes(data)

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        b = bytes(value)
        limit_chunks = (cls.LIMIT + BYTES_PER_CHUNK - 1) // BYTES_PER_CHUNK
        return mix_in_length(
            merkleize(pack_bytes_buf(b), limit=limit_chunks), len(b)
        )


# --- Homogeneous collections -------------------------------------------------


def _is_basic(typ) -> bool:
    return issubclass(typ, (_UInt, boolean))


class Vector(SSZType):
    """Fixed-length list of ELEM (ssz_types::FixedVector)."""

    ELEM: type = None
    LENGTH: int = 0

    def __class_getitem__(cls, params):
        elem, n = params

        def make():
            return type(
                f"Vector[{elem.__name__},{n}]",
                (Vector,),
                {"ELEM": elem, "LENGTH": n},
            )

        return _parametrize(Vector, (elem, n), make)

    @classmethod
    def is_fixed_size(cls):
        return cls.ELEM.is_fixed_size()

    @classmethod
    def fixed_size(cls):
        return cls.ELEM.fixed_size() * cls.LENGTH

    @classmethod
    def coerce(cls, value):
        items = [cls.ELEM.coerce(v) for v in value]
        if len(items) != cls.LENGTH:
            raise ValueError(
                f"{cls.__name__}: expected {cls.LENGTH} items, got {len(items)}"
            )
        return items

    @classmethod
    def default(cls):
        return [cls.ELEM.default() for _ in range(cls.LENGTH)]

    @classmethod
    def encode(cls, value) -> bytes:
        return _encode_homogeneous(cls.ELEM, value)

    @classmethod
    def decode(cls, data: bytes):
        items = _decode_homogeneous(cls.ELEM, data, exact_len=cls.LENGTH)
        return items

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        if _is_basic(cls.ELEM):
            return merkleize(pack_bytes_buf(b"".join(cls.ELEM.encode(v) for v in value)))
        return merkleize([cls.ELEM.hash_tree_root(v) for v in value])


class List(SSZType):
    """Variable-length list of ELEM, limit LIMIT (VariableList)."""

    ELEM: type = None
    LIMIT: int = 0

    def __class_getitem__(cls, params):
        elem, n = params

        def make():
            return type(
                f"List[{elem.__name__},{n}]",
                (List,),
                {"ELEM": elem, "LIMIT": n},
            )

        return _parametrize(List, (elem, n), make)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def coerce(cls, value):
        items = [cls.ELEM.coerce(v) for v in value]
        if len(items) > cls.LIMIT:
            raise ValueError(f"{cls.__name__}: {len(items)} items over limit")
        return items

    @classmethod
    def default(cls):
        return []

    @classmethod
    def encode(cls, value) -> bytes:
        return _encode_homogeneous(cls.ELEM, value)

    @classmethod
    def decode(cls, data: bytes):
        items = _decode_homogeneous(cls.ELEM, data)
        if len(items) > cls.LIMIT:
            raise DecodeError(f"{cls.__name__}: over limit")
        return items

    @classmethod
    def chunk_limit(cls) -> int:
        if _is_basic(cls.ELEM):
            return (
                cls.LIMIT * cls.ELEM.fixed_size() + BYTES_PER_CHUNK - 1
            ) // BYTES_PER_CHUNK
        return cls.LIMIT

    # Lists at or above this many chunks hash through the incremental
    # layer cache (consensus/cached_tree_hash's role: validators and
    # balances dominate state hashing, and consecutive states differ in
    # a handful of entries).
    CACHE_THRESHOLD = 256

    # Memo misses at or above this count merkleize as ONE grove batch
    # (crypto/sha256/grove.py): K width-W element trees stay
    # pair-aligned side by side, so the whole cohort reduces in
    # log2(W) wide engine calls instead of K·(W-1) scalar hashes.
    GROVE_THRESHOLD = 64

    @classmethod
    def _leaves(cls, value):
        if _is_basic(cls.ELEM):
            return pack_bytes(
                b"".join(cls.ELEM.encode(v) for v in value)
            ) if value else []
        # Engine-computed element roots (epoch_engine/soa.RegistryList):
        # after a device-processed epoch the registry hands its roots
        # over as a contiguous plane, skipping the per-element encode +
        # memo walk entirely.  Any mutation drops the plane (None here)
        # and the ordinary paths below take over.
        leaf_roots = getattr(value, "_leaf_roots", None)
        if leaf_roots is not None:
            roots = leaf_roots()
            if roots is not None and len(roots) == len(value):
                return roots
        if len(value) >= cls.CACHE_THRESHOLD:
            memo = cls._element_memo()
            elem = cls.ELEM
            encodings = [elem.encode(v) for v in value]
            leaves = [memo.get(enc) for enc in encodings]
            missing = [i for i, r in enumerate(leaves) if r is None]
            if (len(missing) >= cls.GROVE_THRESHOLD
                    and issubclass(elem, Container)):
                from ..crypto.sha256 import merkleize_grove

                rows = [
                    [t.hash_tree_root(getattr(value[i], f))
                     for f, t in elem._fields.items()]
                    for i in missing
                ]
                for i, root in zip(missing, merkleize_grove(rows)):
                    memo.put(encodings[i], root)
                    leaves[i] = root
            else:
                for i in missing:
                    leaves[i] = memo.get_or_compute(
                        encodings[i],
                        lambda v=value[i]: elem.hash_tree_root(v),
                    )
            return leaves
        return [cls.ELEM.hash_tree_root(v) for v in value]

    @classmethod
    def _element_memo(cls):
        memo = cls.__dict__.get("_elem_memo")
        if memo is None:
            from .cached_tree_hash import ElementRootMemo

            memo = ElementRootMemo()
            cls._elem_memo = memo
        return memo

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        leaves = cls._leaves(value)
        limit = cls.chunk_limit()
        if len(leaves) >= cls.CACHE_THRESHOLD:
            cache = cls.__dict__.get("_tree_cache")
            if cache is None:
                from .cached_tree_hash import CachedListRoot

                width = next_pow_of_two(limit)
                cache = CachedListRoot((width - 1).bit_length())
                cls._tree_cache = cache
            root = cache.root(leaves)
        else:
            root = merkleize(leaves, limit=limit)
        return mix_in_length(root, len(value))


def _encode_homogeneous(elem, items) -> bytes:
    if elem.is_fixed_size():
        return b"".join(elem.encode(v) for v in items)
    parts = [elem.encode(v) for v in items]
    fixed_len = BYTES_PER_LENGTH_OFFSET * len(parts)
    out = bytearray()
    off = fixed_len
    for p in parts:
        out += off.to_bytes(BYTES_PER_LENGTH_OFFSET, "little")
        off += len(p)
    for p in parts:
        out += p
    return bytes(out)


def _decode_homogeneous(elem, data: bytes, exact_len=None):
    if elem.is_fixed_size():
        size = elem.fixed_size()
        if size == 0:
            raise DecodeError("zero-size element")
        if len(data) % size:
            raise DecodeError("length not a multiple of element size")
        items = [
            elem.decode(data[i:i + size]) for i in range(0, len(data), size)
        ]
    else:
        items = _decode_variable_sequence(elem, data)
    if exact_len is not None and len(items) != exact_len:
        raise DecodeError(f"expected {exact_len} items, got {len(items)}")
    return items


def _decode_variable_sequence(elem, data: bytes):
    if not data:
        return []
    if len(data) < BYTES_PER_LENGTH_OFFSET:
        raise DecodeError("truncated offsets")
    first = int.from_bytes(data[:BYTES_PER_LENGTH_OFFSET], "little")
    if first % BYTES_PER_LENGTH_OFFSET or first == 0:
        raise DecodeError("bad first offset")
    count = first // BYTES_PER_LENGTH_OFFSET
    if first > len(data):
        raise DecodeError("offset past end")
    offsets = [first]
    for i in range(1, count):
        o = int.from_bytes(
            data[i * 4:(i + 1) * 4], "little"
        )
        if o < offsets[-1] or o > len(data):
            raise DecodeError("offsets not monotonic / out of range")
        offsets.append(o)
    offsets.append(len(data))
    return [
        elem.decode(data[offsets[i]:offsets[i + 1]]) for i in range(count)
    ]


# --- Bitfields ---------------------------------------------------------------


class Bitvector(SSZType):
    """Fixed-length bit array (ssz_types::BitVector).  Value: list[bool]."""

    LENGTH: int = 0

    def __class_getitem__(cls, n: int):
        def make():
            return type(f"Bitvector{n}", (Bitvector,), {"LENGTH": n})

        return _parametrize(Bitvector, (n,), make)

    @classmethod
    def is_fixed_size(cls):
        return True

    @classmethod
    def fixed_size(cls):
        return (cls.LENGTH + 7) // 8

    @classmethod
    def coerce(cls, value):
        bits = [bool(b) for b in value]
        if len(bits) != cls.LENGTH:
            raise ValueError(f"Bitvector{cls.LENGTH}: got {len(bits)} bits")
        return bits

    @classmethod
    def default(cls):
        return [False] * cls.LENGTH

    @classmethod
    def encode(cls, value) -> bytes:
        return _bits_to_bytes(value)

    @classmethod
    def decode(cls, data: bytes):
        if len(data) != cls.fixed_size():
            raise DecodeError(f"Bitvector{cls.LENGTH}: {len(data)} bytes")
        bits = _bytes_to_bits(data)
        if any(bits[cls.LENGTH:]):
            raise DecodeError("high bits set beyond length")
        return bits[: cls.LENGTH]

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        limit = (cls.LENGTH + 255) // 256
        return merkleize(pack_bytes_buf(_bits_to_bytes(value)), limit=limit)


class Bitlist(SSZType):
    """Variable-length bit list, limit LIMIT (ssz_types::BitList) —
    serialized with a trailing delimiter bit."""

    LIMIT: int = 0

    def __class_getitem__(cls, n: int):
        def make():
            return type(f"Bitlist{n}", (Bitlist,), {"LIMIT": n})

        return _parametrize(Bitlist, (n,), make)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def coerce(cls, value):
        bits = [bool(b) for b in value]
        if len(bits) > cls.LIMIT:
            raise ValueError(f"Bitlist{cls.LIMIT}: {len(bits)} bits")
        return bits

    @classmethod
    def default(cls):
        return []

    @classmethod
    def encode(cls, value) -> bytes:
        return _bits_to_bytes(list(value) + [True])  # delimiter

    @classmethod
    def decode(cls, data: bytes):
        if not data:
            raise DecodeError("empty bitlist encoding")
        if data[-1] == 0:
            raise DecodeError("missing delimiter bit")
        bits = _bytes_to_bits(data)
        # Strip trailing zeros then the delimiter 1.
        while bits and not bits[-1]:
            bits.pop()
        bits.pop()
        if len(bits) > cls.LIMIT:
            raise DecodeError(f"Bitlist{cls.LIMIT}: over limit")
        return bits

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        limit = (cls.LIMIT + 255) // 256
        bits = list(value)
        chunks = pack_bytes_buf(_bits_to_bytes(bits)) if bits else b""
        return mix_in_length(merkleize(chunks, limit=limit), len(bits))


def _bits_to_bytes(bits) -> bytes:
    out = bytearray((len(bits) + 7) // 8)
    for i, b in enumerate(bits):
        if b:
            out[i // 8] |= 1 << (i % 8)
    return bytes(out)


def _bytes_to_bits(data: bytes):
    return [bool((byte >> j) & 1) for byte in data for j in range(8)]


# --- Containers --------------------------------------------------------------


class _ContainerMeta(type):
    def __new__(mcs, name, bases, ns):
        cls = super().__new__(mcs, name, bases, ns)
        fields: Dict[str, type] = {}
        for base in reversed(cls.__mro__):
            for fname, ftyp in base.__dict__.get("__annotations__", {}).items():
                if fname.startswith("_"):
                    continue
                if isinstance(ftyp, str):
                    raise TypeError(
                        f"{name}.{fname}: string annotation — the defining "
                        "module must not use `from __future__ import "
                        "annotations`"
                    )
                if isinstance(ftyp, type) and issubclass(ftyp, SSZType):
                    fields[fname] = ftyp
        cls._fields = fields
        return cls


class Container(SSZType, metaclass=_ContainerMeta):
    """Declarative SSZ container:

        class Checkpoint(Container):
            epoch: uint64
            root: Bytes32

    Field order = declaration order (inheritance-extended).  Instances are
    mutable attribute bags; `copy()` is a deep structural copy (the
    equivalent of the reference's Clone on consensus types).
    """

    _fields: Dict[str, type] = {}

    def __init__(self, **kwargs):
        for fname, ftyp in self._fields.items():
            if fname in kwargs:
                setattr(self, fname, ftyp.coerce(kwargs.pop(fname)))
            else:
                setattr(self, fname, ftyp.default())
        if kwargs:
            raise TypeError(f"unknown fields {sorted(kwargs)}")

    # -- SSZType surface --

    @classmethod
    def is_fixed_size(cls):
        return all(t.is_fixed_size() for t in cls._fields.values())

    @classmethod
    def fixed_size(cls):
        if not cls.is_fixed_size():
            raise NotImplementedError(f"{cls.__name__} is variable-size")
        return sum(t.fixed_size() for t in cls._fields.values())

    @classmethod
    def coerce(cls, value):
        if isinstance(value, cls):
            return value
        if isinstance(value, dict):
            return cls(**value)
        raise ValueError(f"cannot coerce {value!r} to {cls.__name__}")

    @classmethod
    def default(cls):
        return cls()

    @classmethod
    def encode(cls, value) -> bytes:
        fixed_parts = []
        variable_parts = []
        for fname, ftyp in cls._fields.items():
            v = getattr(value, fname)
            if ftyp.is_fixed_size():
                fixed_parts.append(ftyp.encode(v))
                variable_parts.append(b"")
            else:
                fixed_parts.append(None)
                variable_parts.append(ftyp.encode(v))
        fixed_len = sum(
            len(p) if p is not None else BYTES_PER_LENGTH_OFFSET
            for p in fixed_parts
        )
        out = bytearray()
        off = fixed_len
        for p, v in zip(fixed_parts, variable_parts):
            if p is not None:
                out += p
            else:
                out += off.to_bytes(BYTES_PER_LENGTH_OFFSET, "little")
                off += len(v)
        for v in variable_parts:
            out += v
        return bytes(out)

    @classmethod
    def decode(cls, data: bytes):
        # Pass 1: walk fixed region collecting values / offsets.
        pos = 0
        offsets = []
        fixed_vals: Dict[str, Any] = {}
        var_fields = []
        for fname, ftyp in cls._fields.items():
            if ftyp.is_fixed_size():
                size = ftyp.fixed_size()
                if pos + size > len(data):
                    raise DecodeError(f"truncated at field {fname}")
                fixed_vals[fname] = ftyp.decode(data[pos:pos + size])
                pos += size
            else:
                if pos + BYTES_PER_LENGTH_OFFSET > len(data):
                    raise DecodeError(f"truncated offset at {fname}")
                offsets.append(
                    int.from_bytes(data[pos:pos + 4], "little")
                )
                var_fields.append((fname, ftyp))
                pos += BYTES_PER_LENGTH_OFFSET
        if offsets:
            if offsets[0] != pos:
                raise DecodeError("first offset != fixed size")
            offsets.append(len(data))
            for o1, o2 in zip(offsets, offsets[1:]):
                if o1 > o2 or o2 > len(data):
                    raise DecodeError("bad offsets")
            for (fname, ftyp), o1, o2 in zip(var_fields, offsets, offsets[1:]):
                fixed_vals[fname] = ftyp.decode(data[o1:o2])
        elif pos != len(data):
            raise DecodeError("trailing bytes")
        return cls(**fixed_vals)

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        return merkleize(
            [t.hash_tree_root(getattr(value, f)) for f, t in cls._fields.items()]
        )

    # -- value conveniences --

    def copy(self):
        out = type(self).__new__(type(self))
        for fname, ftyp in self._fields.items():
            v = getattr(self, fname)
            out_v = v
            if isinstance(v, Container):
                out_v = v.copy()
            elif isinstance(v, list):
                out_v = [e.copy() if isinstance(e, Container) else e for e in v]
            setattr(out, fname, out_v)
        return out

    def __eq__(self, other):
        if type(other) is not type(self):
            return NotImplemented
        return all(
            getattr(self, f) == getattr(other, f) for f in self._fields
        )

    def __hash__(self):
        return hash(type(self).encode(self))

    def __repr__(self):
        inner = ", ".join(
            f"{f}={getattr(self, f)!r}" for f in list(self._fields)[:4]
        )
        more = "..." if len(self._fields) > 4 else ""
        return f"{type(self).__name__}({inner}{more})"


# --- Union -------------------------------------------------------------------


class Union(SSZType):
    """SSZ union; value = (selector: int, inner).  Union[T0, T1, ...];
    T0 may be None for the null arm."""

    ARMS: Tuple = ()

    def __class_getitem__(cls, arms):
        if not isinstance(arms, tuple):
            arms = (arms,)

        def make():
            return type(
                f"Union[{','.join(a.__name__ if a else 'None' for a in arms)}]",
                (Union,),
                {"ARMS": arms},
            )

        return _parametrize(Union, arms, make)

    @classmethod
    def is_fixed_size(cls):
        return False

    @classmethod
    def coerce(cls, value):
        sel, inner = value
        arm = cls.ARMS[sel]
        if arm is None:
            if inner is not None:
                raise ValueError("null arm carries no value")
            return (sel, None)
        return (sel, arm.coerce(inner))

    @classmethod
    def default(cls):
        arm = cls.ARMS[0]
        return (0, None if arm is None else arm.default())

    @classmethod
    def encode(cls, value) -> bytes:
        sel, inner = value
        arm = cls.ARMS[sel]
        body = b"" if arm is None else arm.encode(inner)
        return bytes([sel]) + body

    @classmethod
    def decode(cls, data: bytes):
        if not data:
            raise DecodeError("empty union")
        sel = data[0]
        if sel >= len(cls.ARMS):
            raise DecodeError(f"union selector {sel} out of range")
        arm = cls.ARMS[sel]
        if arm is None:
            if len(data) != 1:
                raise DecodeError("null arm with body")
            return (sel, None)
        return (sel, arm.decode(data[1:]))

    @classmethod
    def hash_tree_root(cls, value) -> bytes:
        sel, inner = value
        arm = cls.ARMS[sel]
        root = b"\x00" * 32 if arm is None else arm.hash_tree_root(inner)
        return mix_in_selector(root, sel)
