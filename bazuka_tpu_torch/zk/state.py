"""ZK state machine: typed contract state over a sparse quad-Merkle forest.

Semantics mirror the reference bit-for-bit (state roots, pruning, proofs):
  * `ZkStateModel` — Scalar | Struct{fields} | List{log4_size, item}
    (reference: src/zk/mod.rs:333-345)
  * `locate` / `compress_default` (reference: src/zk/mod.rs:367-423)
  * `StateManager.set_data` — bottom-up 4-ary path rehash with
    default-subtree pruning and state-size tracking
    (reference: src/zk/state/mod.rs:310-420)
  * `prove` — 3-siblings-per-level Merkle proofs
    (reference: src/zk/state/mod.rs:218-264)
  * `update_contract` — delta replay in a fork, then commit root+height
    (reference: src/zk/state/mod.rs:285-308)

Scalars are canonical Python ints (0..p-1) at this layer.  A copy of
`bazuka_tpu/zk/state.py`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List as PyList, Optional, Tuple

from ..db import KvStore, Put, Remove, keys
from ..fields.host import FR_MODULUS
from ..utils import ser
from .poseidon_host import PoseidonHasher

# ---------------------------------------------------------------- models


@dataclass(frozen=True)
class Scalar:
    def write_to(self, w: ser.Writer):
        w.variant(0)

    def __repr__(self):
        return "Scalar"


@dataclass(frozen=True)
class Struct:
    field_types: Tuple["ZkStateModel", ...]

    def __init__(self, field_types):
        object.__setattr__(self, "field_types", tuple(field_types))

    def write_to(self, w: ser.Writer):
        w.variant(1)
        w.seq(self.field_types, lambda w, m: m.write_to(w))


@dataclass(frozen=True)
class ListModel:
    log4_size: int
    item_type: "ZkStateModel"

    def write_to(self, w: ser.Writer):
        w.variant(2)
        w.u8(self.log4_size)
        self.item_type.write_to(w)


ZkStateModel = object  # Scalar | Struct | ListModel
SCALAR = Scalar()


def read_state_model(r: ser.Reader):
    v = r.variant()
    if v == 0:
        return SCALAR
    if v == 1:
        return Struct(tuple(r.seq(read_state_model)))
    if v == 2:
        return ListModel(r.u8(), read_state_model(r))
    raise ValueError(f"bad state model tag {v}")


class ZkLocatorError(Exception):
    pass


def locate(model: ZkStateModel, locator: Tuple[int, ...]) -> ZkStateModel:
    """Sub-model at `locator` (reference: src/zk/mod.rs:367-390)."""
    curr = model
    for l in locator:
        if isinstance(curr, Struct):
            if l >= len(curr.field_types):
                raise ZkLocatorError("locator pointing to nonexistent elements")
            curr = curr.field_types[l]
        elif isinstance(curr, ListModel):
            if l >= 1 << (2 * curr.log4_size):
                raise ZkLocatorError("locator pointing to nonexistent elements")
            curr = curr.item_type
        else:
            raise ZkLocatorError("locator pointing to nonexistent elements")
    return curr


_DEFAULT_CACHE: Dict[Tuple[int, ZkStateModel], int] = {}


def compress_default(model: ZkStateModel, hasher=PoseidonHasher) -> int:
    """Hash of the all-default subtree (reference: src/zk/mod.rs:401-423)."""
    key = (id(hasher), model)
    hit = _DEFAULT_CACHE.get(key)
    if hit is not None:
        return hit
    if isinstance(model, Scalar):
        out = 0
    elif isinstance(model, Struct):
        out = hasher.hash([compress_default(f, hasher) for f in model.field_types])
    else:
        out = compress_default(model.item_type, hasher)
        for _ in range(model.log4_size):
            out = hasher.hash([out, out, out, out])
    _DEFAULT_CACHE[key] = out
    return out


def model_is_valid(model: ZkStateModel, hasher=PoseidonHasher) -> bool:
    if isinstance(model, Struct):
        if len(model.field_types) > hasher.MAX_ARITY:
            return False
        return all(model_is_valid(f, hasher) for f in model.field_types)
    if isinstance(model, ListModel):
        return model_is_valid(model.item_type, hasher)
    return True


# ---------------------------------------------------------------- locators


def loc_str(locator: Tuple[int, ...]) -> str:
    """Display format: lowercase-hex indices joined by '_'
    (reference: src/zk/mod.rs ZkDataLocator Display)."""
    return "_".join(f"{n:x}" for n in locator)


def loc_parse(s: str) -> Tuple[int, ...]:
    if s == "":
        return ()
    return tuple(int(part, 16) for part in s.split("_"))


# ---------------------------------------------------------------- codecs


def scalar_to_blob(x: int) -> bytes:
    return (x % FR_MODULUS).to_bytes(32, "little")


def blob_to_scalar(b: bytes) -> int:
    v = int.from_bytes(b, "little")
    if v >= FR_MODULUS:
        raise ValueError("non-canonical scalar blob")
    return v


def u64_to_blob(x: int) -> bytes:
    return int(x).to_bytes(8, "little")


def blob_to_u64(b: bytes) -> int:
    return int.from_bytes(b, "little")


@dataclass(frozen=True)
class ZkCompressedState:
    """(root hash, number of non-default leaves)."""

    state_hash: int
    state_size: int

    @staticmethod
    def empty(model: ZkStateModel, hasher=PoseidonHasher) -> "ZkCompressedState":
        return ZkCompressedState(compress_default(model, hasher), 0)

    def write_to(self, w: ser.Writer):
        w.big(self.state_hash, 32).u64(self.state_size)

    @staticmethod
    def read_from(r: ser.Reader) -> "ZkCompressedState":
        return ZkCompressedState(r.big(32), r.u64())


# ---------------------------------------------------------------- contract


@dataclass
class ZkContract:
    """On-chain contract descriptor (reference: src/zk/mod.rs ZkContract)."""

    initial_state: ZkCompressedState
    state_model: ZkStateModel
    deposit_functions: PyList = field(default_factory=list)  # ZkMultiInputVerifierKey
    withdraw_functions: PyList = field(default_factory=list)
    functions: PyList = field(default_factory=list)  # ZkSingleInputVerifierKey
    token: Optional[object] = None  # ZkTokenContract

    def write_to(self, w: ser.Writer):
        from .proof import write_multi_vk, write_single_vk, write_token_contract

        self.initial_state.write_to(w)
        self.state_model.write_to(w)
        w.seq(self.deposit_functions, write_multi_vk)
        w.seq(self.withdraw_functions, write_multi_vk)
        w.seq(self.functions, write_single_vk)
        w.option(self.token, write_token_contract)

    @staticmethod
    def read_from(r: ser.Reader) -> "ZkContract":
        from .proof import read_multi_vk, read_single_vk, read_token_contract

        initial_state = ZkCompressedState.read_from(r)
        model = read_state_model(r)
        dep = r.seq(read_multi_vk)
        wit = r.seq(read_multi_vk)
        fns = r.seq(read_single_vk)
        token = r.option(read_token_contract)
        return ZkContract(initial_state, model, dep, wit, fns, token)


# ---------------------------------------------------------------- manager


class StateManagerError(Exception):
    pass


class ContractNotFound(StateManagerError):
    pass


class StateManager:
    """KV-backed sparse quad-Merkle forest, one namespace per contract.

    All methods are static over (db, contract id, hasher); `cid` is the
    contract's display string (the key namespace `S-<cid>-...`).
    """

    def __init__(self, hasher=PoseidonHasher):
        self.h = hasher

    # -- contract metadata

    def type_of(self, db: KvStore, cid: str) -> ZkStateModel:
        blob = db.get(keys.contract(cid))
        if blob is None:
            raise ContractNotFound(cid)
        return ser.loads(ZkContract, blob).state_model

    def height_of(self, db: KvStore, cid: str) -> int:
        blob = db.get(keys.local_height(cid))
        return blob_to_u64(blob) if blob is not None else 0

    def root(self, db: KvStore, cid: str) -> ZkCompressedState:
        blob = db.get(keys.local_root(cid))
        if blob is not None:
            return ser.loads(ZkCompressedState, blob)
        return ZkCompressedState.empty(self.type_of(db, cid), self.h)

    # -- reads

    def get_data(self, db: KvStore, cid: str, locator: Tuple[int, ...]) -> int:
        model = self.type_of(db, cid)
        sub = locate(model, locator)
        is_scalar = isinstance(sub, Scalar)
        blob = db.get(keys.local_value(cid, loc_str(locator), is_scalar))
        if blob is not None:
            return blob_to_scalar(blob)
        return compress_default(sub, self.h)

    # -- writes

    def set_data(
        self, db: KvStore, cid: str, locator: Tuple[int, ...], value: int
    ) -> Tuple[int, int]:
        """Set one scalar leaf; returns (new root hash, state-size delta).

        Walks the locator bottom-up rehashing each enclosing List level
        (4-ary, pruning default aux nodes) and each enclosing Struct
        (reference: src/zk/state/mod.rs:310-420).
        """
        model = self.type_of(db, cid)
        if not isinstance(locate(model, locator), Scalar):
            raise StateManagerError("not locating a scalar")
        h = self.h
        ops = []
        value = value % FR_MODULUS

        prev = self.get_data(db, cid, locator)
        if prev == value:
            return self.get_data(db, cid, ()), 0

        size_diff = 0
        if value == 0:
            if prev != 0:
                size_diff -= 1
            ops.append(Remove(keys.local_value(cid, loc_str(locator), True)))
        else:
            if prev == 0:
                size_diff += 1
            ops.append(
                Put(keys.local_value(cid, loc_str(locator), True), scalar_to_blob(value))
            )

        loc = list(locator)
        while loc:
            curr_loc = loc.pop()
            curr_type = locate(model, tuple(loc))
            if isinstance(curr_type, ListModel):
                curr_ind = curr_loc
                default_value = compress_default(curr_type.item_type, h)
                for layer in range(curr_type.log4_size - 1, -1, -1):
                    aux_offset = ((1 << (2 * (layer + 1))) - 1) // 3
                    start = curr_ind - (curr_ind % 4)
                    dats = []
                    for leaf_index in range(start, start + 4):
                        if leaf_index == curr_ind:
                            dats.append(value)
                        elif layer == curr_type.log4_size - 1:
                            dats.append(
                                self.get_data(db, cid, tuple(loc) + (leaf_index,))
                            )
                        else:
                            blob = db.get(
                                keys.local_tree_aux(
                                    cid, loc_str(tuple(loc)), aux_offset + leaf_index
                                )
                            )
                            dats.append(
                                blob_to_scalar(blob) if blob is not None else default_value
                            )
                    value = h.hash(dats)
                    default_value = h.hash([default_value] * 4)
                    curr_ind //= 4
                    if layer > 0:
                        parent_aux_offset = ((1 << (2 * layer)) - 1) // 3
                        aux_key = keys.local_tree_aux(
                            cid, loc_str(tuple(loc)), parent_aux_offset + curr_ind
                        )
                        if value == default_value:
                            ops.append(Remove(aux_key))
                        else:
                            ops.append(Put(aux_key, scalar_to_blob(value)))
            elif isinstance(curr_type, Struct):
                dats = []
                for field_index in range(len(curr_type.field_types)):
                    if field_index == curr_loc:
                        dats.append(value)
                    else:
                        dats.append(self.get_data(db, cid, tuple(loc) + (field_index,)))
                value = h.hash(dats)
            else:
                raise AssertionError("scalar cannot enclose a locator")

            key = keys.local_value(cid, loc_str(tuple(loc)), False)
            if value == compress_default(curr_type, h):
                ops.append(Remove(key))
            else:
                ops.append(Put(key, scalar_to_blob(value)))

        db.update(ops)
        return value, size_diff

    def update_contract(
        self, db: KvStore, cid: str, patch: Dict[Tuple[int, ...], Optional[int]],
        target_height: int,
    ) -> None:
        """Apply a delta in a fork, then commit new root + height
        (reference: src/zk/state/mod.rs:285-308)."""
        fork = db.mirror()
        root = self.root(fork, cid)
        state_hash, state_size = root.state_hash, root.state_size
        for loc, val in patch.items():
            state_hash, d = self.set_data(fork, cid, tuple(loc), val or 0)
            state_size += d
        fork.update(
            [
                Put(
                    keys.local_root(cid),
                    ser.dumps(ZkCompressedState(state_hash, state_size)),
                ),
                Put(keys.local_height(cid), u64_to_blob(target_height)),
            ]
        )
        db.update(fork.to_ops())

    # -- proofs

    def prove(
        self, db: KvStore, cid: str, tree_loc: Tuple[int, ...], ind: int
    ) -> PyList[Tuple[int, int, int]]:
        """Merkle proof for list element `ind`: per level, the 3 siblings
        bottom-up (reference: src/zk/state/mod.rs:218-264)."""
        loc_type = locate(self.type_of(db, cid), tree_loc)
        if not isinstance(loc_type, ListModel):
            raise StateManagerError("not locating a tree")
        h = self.h
        default_value = compress_default(loc_type.item_type, h)
        proof = []
        curr_ind = ind
        for layer in range(loc_type.log4_size - 1, -1, -1):
            part = []
            aux_offset = ((1 << (2 * (layer + 1))) - 1) // 3
            start = curr_ind - (curr_ind % 4)
            for leaf_index in range(start, start + 4):
                if leaf_index == curr_ind:
                    continue
                if layer == loc_type.log4_size - 1:
                    part.append(self.get_data(db, cid, tree_loc + (leaf_index,)))
                else:
                    blob = db.get(
                        keys.local_tree_aux(
                            cid, loc_str(tree_loc), aux_offset + leaf_index
                        )
                    )
                    part.append(
                        blob_to_scalar(blob) if blob is not None else default_value
                    )
            curr_ind //= 4
            default_value = h.hash([default_value] * 4)
            proof.append(tuple(part))
        return proof


# ---------------------------------------------------------------- builder

DUMMY_CONTRACT_ID = "0x" + "00" * 32


class ZkStateBuilder:
    """In-RAM single-contract state builder (reference:
    src/zk/state/mod.rs:34-90): genesis states, aux-data roots,
    token-subtree hashes."""

    def __init__(self, state_model: ZkStateModel, hasher=PoseidonHasher):
        from ..db import RamKvStore

        self.cid = DUMMY_CONTRACT_ID
        self.db = RamKvStore()
        self.mgr = StateManager(hasher)
        contract = ZkContract(
            initial_state=ZkCompressedState.empty(state_model, hasher),
            state_model=state_model,
        )
        self.db.update([Put(keys.contract(self.cid), ser.dumps(contract))])

    def batch_set(self, delta: Dict[Tuple[int, ...], Optional[int]]):
        height = self.mgr.height_of(self.db, self.cid)
        self.mgr.update_contract(self.db, self.cid, delta, height + 1)

    def get(self, loc: Tuple[int, ...]) -> int:
        return self.mgr.get_data(self.db, self.cid, tuple(loc))

    def compress(self) -> ZkCompressedState:
        return self.mgr.root(self.db, self.cid)

    def prove(self, tree_loc: Tuple[int, ...], ind: int):
        return self.mgr.prove(self.db, self.cid, tuple(tree_loc), ind)


def compress_state(
    model: ZkStateModel, data: Dict[Tuple[int, ...], int], hasher=PoseidonHasher
) -> ZkCompressedState:
    """Compress full data pairs against a model (reference:
    src/zk/mod.rs ZkStateModel::compress)."""
    b = ZkStateBuilder(model, hasher)
    b.batch_set({k: v for k, v in data.items()})
    return b.compress()
