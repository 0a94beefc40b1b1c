"""SimpleSerialize (SSZ) — encode/decode, typed collections, and
merkleization.

The equivalent of the reference's `consensus/ssz` (encode/decode),
`consensus/ssz_derive` (derive macros -> here: declarative `Container`
field annotations), `consensus/ssz_types` (FixedVector/VariableList/
Bitfield with typenum lengths -> parameterized `Vector[T, N]` etc.), and
`consensus/tree_hash` (hash_tree_root) crates
(Lighthouse's consensus/{ssz,ssz_types,tree_hash}/src/lib.rs).

Values are plain Python objects (int, bool, bytes, list, Container
instances); SSZ *types* are classes carrying the codec/merkleization.
"""
from .core import (
    Bitlist,
    Bitvector,
    ByteList,
    ByteVector,
    Bytes4,
    Bytes20,
    Bytes32,
    Bytes48,
    Bytes96,
    Container,
    DecodeError,
    List,
    SSZType,
    Union,
    Vector,
    boolean,
    uint8,
    uint16,
    uint32,
    uint64,
    uint128,
    uint256,
)
from .hash import ZERO_HASHES, hash_bytes, hash_tree_root, merkleize, mix_in_length

__all__ = [
    "Bitlist", "Bitvector", "ByteList", "ByteVector", "Bytes4", "Bytes20",
    "Bytes32", "Bytes48", "Bytes96", "Container", "DecodeError", "List",
    "SSZType", "Union", "Vector", "boolean", "uint8", "uint16", "uint32",
    "uint64", "uint128", "uint256", "ZERO_HASHES", "hash_bytes",
    "hash_tree_root", "merkleize", "mix_in_length",
]
