"""Corpus-sharded index (SURVEY.md §7 step 7), port of
``fspann_tpu/parallel/sharded.py``.

The reference is a single JVM; its only scale-out analogue is N independent
RocksDB shards (``common/ShardedMetadataManager.java``).  Here the *corpus*
(the rows of the routing arrays) is cut into ``n`` equal row ranges, one per
shard:

* each shard builds partitions over its own rows (sorts are local, because
  partition blocks never span shards),
* queries are shared; each shard routes (and, in the plaintext mode,
  refines) against its own rows and produces a local top-K,
* one merge over the shards' blocks yields the global top-K.  The merged
  payload is ``n * Q * K`` ids and scores — tiny next to the sharded state.

**The mesh.**  A :class:`Mesh` is an ordered tuple of device *slots* with
the ``n`` shards spread over them in contiguous, equal groups: shard ``s``
lives on slot ``s // (n // len(slots))`` and its global row ids are ``s *
rows + local``, the layout of the JAX package's mesh over its devices in
order.  A slot is a torch device, and two slots may name the same one (the
CPU tests emulate an 8-device mesh so; one card runs the multi-slot code
so).  Every resident array (``bits``, ``words``, ``popc``, ``tombs``,
``point_codes``, ``base``, and the per-shard partition tables stacked ``[n
per slot, G, P, ...]``) is a list with ONE tensor per slot, whatever the
slot count, holding that slot's shards back to back on the slot's device;
a shard is a view of its range, never a copy
(:meth:`ShardedIndex._per_device` gives the list,
:meth:`ShardedIndex._gather_host` the host concatenation).

A step replicates the queries to every distinct device and encodes them
there (the JAX package's ``P(None)`` queries), then issues every shard's
work on its slot's device before it waits on anything: no host sync, no
data-dependent shape in the per-shard loop, so the cards run at once from
one host thread.  The shards of one device run one after another on its
stream.

The merge keeps its configured names (``runtime.mesh_merge``): ``"ici"``
gathers every shard's (id, score) block onto the first slot's device (peer
copies, over NVLink where the cards have it; no copy where the slots share
the card; never through the host) and merges there, the counterpart of the
JAX package's ``all_gather`` + replicated merge; ``"host"`` copies each
slot's blocks to pinned host memory, with an event on that slot's device,
and merges them there (:func:`host_merge_topl`).  Both give the same bits.

This module implements the *plaintext/trusted-refine* serving mode (vectors
resident next to their routing shard) and the route-only steps of the
encrypted mode, which keeps refine on the host exactly as in the
single-device path, with per-shard ciphertext arenas (the host side is
shard-agnostic: candidate ids are global).

Order contracts are the single-device modules' (``ops/routing``,
``ops/hamming_scan``): ids and scores are int32 (pads INT32_MAX on the way
to a merge, -1 after it), every (score, id) ranking runs on one int64 key.
``approx=True``, the default as in the JAX package, selects each shard's
top-L with ``ops/approx_topk`` (the TPU's ``approx_max_k``, over the shard's
own rows); the merge stays exact, and ``approx=False`` is the exact top-L.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch

from .. import resolve_device
from ..ops import coding, hamming_scan, partition, routing
from ..ops.hamming_scan import _DEAD
from ..ops.partition import PartitionTable
from ..ops.routing import _LOW32, INT32_MAX
from ..query.service import _HostCopy

_UNPACK_CHUNK = 65_536        # rows unpacked at a time while building


@dataclasses.dataclass(frozen=True)
class Mesh:
    """``n_shards`` row ranges of one corpus over ``slots`` (torch devices,
    in order; repeats allowed), ``n_shards // len(slots)`` consecutive
    shards on each; ``axis`` names the shard axis, as the JAX package's
    mesh names its one axis."""

    n_shards: int
    slots: tuple
    axis: str = "shard"

    def __post_init__(self):
        if self.n_shards <= 0:
            raise ValueError("a mesh needs at least one shard")
        if not self.slots:
            raise ValueError("a mesh needs at least one slot")
        if self.n_shards % len(self.slots):
            raise ValueError(f"{self.n_shards} shards do not split evenly "
                             f"over {len(self.slots)} slots")

    @property
    def device(self) -> torch.device:
        """The first slot's device: where the ``"ici"`` merge lands and
        callers read results."""
        return self.slots[0]

    @property
    def shards_per_slot(self) -> int:
        return self.n_shards // len(self.slots)

    @property
    def devices(self) -> tuple:
        """The distinct devices of the slots, in slot order."""
        return tuple(dict.fromkeys(self.slots))


def _as_slot(device) -> torch.device:
    """``device`` as a slot: a CUDA device gets its index (the current
    device when it names none) and must be visible."""
    device = resolve_device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        index = torch.cuda.current_device() if device.index is None \
            else device.index
        if index >= count:
            raise ValueError(f"cuda:{index} is not visible: this host has "
                             f"{count} CUDA device(s)")
        device = torch.device("cuda", index)
    return device


def make_mesh(n_devices: int | None = None, axis: str = "shard", *,
              devices=None, device=None) -> Mesh:
    """``n_devices`` shards over device slots, the shard axis named
    ``axis`` (the JAX package's signature).

    * ``devices=[...]`` names the slots (``n_devices`` defaults to one
      shard a slot);
    * ``device=d`` is ``devices=[d]``, one slot holding every shard, except
      that ``n_devices`` defaults to the number of visible CUDA devices for
      a CUDA device and to 1 on the CPU;
    * neither is the first ``min(n_devices, card count)`` visible CUDA
      cards, one slot each, as the JAX package's ``jax.devices()[:n]``
      (``n_devices`` defaults to the card count); without a card this
      raises, as every entry point of the port does.

    A shard count that does not split evenly over the slots raises
    ``ValueError``, and so does a CUDA device the host does not have: no
    mesh is silently stacked on fewer cards."""
    if device is not None:
        if devices is not None:
            raise ValueError("name the slots by device= or by devices=, "
                             "not both")
        devices = [device]
    if devices is not None:
        slots = tuple(_as_slot(d) for d in devices)
        if n_devices is None and device is not None \
                and slots[0].type == "cuda":
            n_devices = torch.cuda.device_count()
    else:
        resolve_device(None)
        cards = torch.cuda.device_count()
        if n_devices is None:
            n_devices = cards
        slots = tuple(torch.device("cuda", i)
                      for i in range(min(max(n_devices, 1), cards)))
    return Mesh(int(len(slots) if n_devices is None else n_devices), slots,
                axis)


def resolve_scan_layout(mode, shard_rows: int, bits_per_row: int,
                        device=None):
    """Map a scan-layout request to a concrete ``keep_bits`` value.

    ``mode``: False (no scan state), True/"off" (unpacked int8 bit matrix),
    "packed"/"on" (int32 words, 8× fewer resident bytes, per-chunk unpack
    inside the scan), or "auto" (pack only when the unpacked matrix of
    ``shard_rows`` rows would not fit 60% of ``device``'s free memory; 4 GiB
    on the CPU, which reports no memory stats).  Where several shards share
    ``device``, the caller passes the rows of all of them.
    """
    if mode in (False, None):
        return False
    if mode in (True, "off"):
        return True
    if mode in ("packed", "on"):
        return "packed"
    if mode != "auto":
        raise ValueError(f"unknown scan layout {mode!r}")
    from ..utils.devmem import free_memory_budget
    budget = free_memory_budget(6, 10, fallback=4 << 30, device=device)
    return "packed" if shard_rows * bits_per_row > budget else True


def _assemble_dim1(arr) -> np.ndarray:
    """[Q, k*n] per-shard blocks side by side → host numpy; a list of
    per-slot parts is concatenated along dim 1 in slot order."""
    if isinstance(arr, np.ndarray):
        return arr
    if isinstance(arr, torch.Tensor):
        return arr.cpu().numpy()
    return np.concatenate([_assemble_dim1(a) for a in arr], axis=1)


def host_merge_topl(ids, sc, limit: int):
    """Exact host replica of the device scan merge: ascending 2-key
    (score, id) order over the union of per-shard top-Ls, first ``limit``
    kept, dead entries → id −1.  Packing both int32 keys into one int64
    (score<<32 | id, both non-negative) makes a single argpartition+sort
    reproduce the 2-key sort bit-exactly."""
    pad32 = np.iinfo(np.int32).max
    ids_np = _assemble_dim1(ids).astype(np.int64)
    sc_np = _assemble_dim1(sc).astype(np.int64)
    key = (sc_np << 32) | ids_np
    r = min(limit, key.shape[1])
    if r < key.shape[1]:
        head = np.take_along_axis(
            key, np.argpartition(key, r - 1, axis=1)[:, :r], axis=1)
    else:
        head = key
    head = np.sort(head, axis=1)
    sc_m = (head >> 32).astype(np.int32)
    ids_m = (head & 0xFFFFFFFF).astype(np.int32)
    return np.where(sc_m == pad32, -1, ids_m), sc_m


def _gather(blocks: list, device: torch.device) -> torch.Tensor:
    """The shards' [Q, k] blocks side by side on ``device``: a peer copy
    from each other device (queued on the streams, never through the
    host), none for a block already there."""
    return torch.cat([b.to(device, non_blocking=True) for b in blocks],
                     dim=1)


def _merge_device(ids_blocks: list, sc_blocks: list, limit: int,
                  device: torch.device):
    """The device merge (``merge="ici"``): the shards' (id, score) blocks
    gathered onto ``device``, the first ``min(limit, width)`` in ascending
    (score, id) order on one int64 key, INT32_MAX ids → -1."""
    all_ids = _gather(ids_blocks, device)
    all_sc = _gather(sc_blocks, device)
    key = (all_sc.to(torch.int64) << 32) | all_ids.to(torch.int64)
    r = min(limit, key.shape[1])
    key = torch.topk(key, r, dim=1, largest=False, sorted=True).values
    sc = (key >> 32).to(torch.int32)
    ids = (key & _LOW32).to(torch.int32)
    return torch.where(ids == INT32_MAX, torch.full_like(ids, -1), ids), sc


class _Dispatched:
    """A dispatched route: device→host copies in flight (pinned,
    non-blocking, one event per source device), waited for by :meth:`get`.
    ``ids`` and ``sc`` are lists of tensors: the merged result, or with
    ``host_limit`` set the per-slot blocks, which :meth:`get` merges on the
    host."""

    def __init__(self, ids: list, sc: list, host_limit: int | None = None):
        self._n = len(ids)
        self._copy = _HostCopy(ids + sc)
        self._host_limit = host_limit

    def get(self) -> tuple[np.ndarray, np.ndarray]:
        out = self._copy.get()
        ids, sc = out[:self._n], out[self._n:]
        if self._host_limit is not None:
            return host_merge_topl(ids, sc, self._host_limit)
        return ids[0], sc[0]


class ShardedIndex:
    """Plaintext corpus cut into shards with per-shard partition tables."""

    def __init__(self, mesh: Mesh, bank: coding.GBank, block_size: int = 64,
                 wide_keys: bool = False):
        self.mesh = mesh
        self.device = mesh.device
        self.bank = bank
        # one copy of the bank's arrays on each distinct device
        self._banks = {dev: coding.bank_to(bank, dev)
                       for dev in mesh.devices}
        self.block_size = block_size
        # full code-prefix partition order past the 63-bit key
        # (ops/partition.build_partitions(wide=); runtime.wide_keys)
        self.wide_keys = wide_keys
        self.n_devices = mesh.n_shards
        # each resident array: a list, one tensor per slot (see the module
        # notes)
        self.table = None          # PartitionTable, fields [n/slot, G, ...]
        self.base = None           # f32 [rows/slot, d]
        self.point_codes = None    # int32 [rows/slot, G, W]
        self.bits = None           # int8 [rows/slot, B]
        self.words = None          # int32 [rows/slot, G, W]
        #   packed scan words (8× fewer resident bytes; mutually exclusive
        #   with `bits` — see resolve_scan_layout)
        self.popc = None           # int32 [rows/slot]
        self.tombs = None          # bool [rows/slot]
        self.shard_rows = 0
        self.n = 0
        # scan-merge backend: "ici" = gather onto the first slot's device
        # and merge there, "host" = the per-slot top-Ls cross to the host
        # and host_merge_topl does the identical exact merge
        self.merge_backend = "ici"

    # -- layout ------------------------------------------------------------------

    @property
    def _slot_rows(self) -> int:
        """Rows of one slot's tensors: its shards back to back."""
        return self.shard_rows * self.mesh.shards_per_slot

    def _slot_device(self, s: int) -> torch.device:
        """The device of shard ``s``'s slot."""
        return self.mesh.slots[s // self.mesh.shards_per_slot]

    def _shard(self, arr, s: int) -> torch.Tensor:
        """Shard ``s``'s row range of a resident array — a view into its
        slot's tensor."""
        spp = self.mesh.shards_per_slot
        lo = (s % spp) * self.shard_rows
        return arr[s // spp][lo:lo + self.shard_rows]

    def _shard_table(self, table, s: int) -> PartitionTable:
        spp = self.mesh.shards_per_slot
        return PartitionTable(*(None if f is None else f[s % spp]
                                for f in table[s // spp]))

    def _per_device(self, arr) -> list:
        """A resident array as its per-slot tensors, in shard order (the
        JAX package's per-device arrays)."""
        return list(arr)

    def _gather_host(self, arr) -> np.ndarray:
        """A resident array on the host: each slot's tensor copied on its
        own and the copies concatenated in shard order."""
        return np.concatenate([p.cpu().numpy() for p in arr])

    def _init_tombs(self) -> None:
        """Fresh all-false tombstone mask (one bool per padded row) on every
        slot.  Deletions are a runtime input to every query step."""
        self.tombs = [torch.zeros(self._slot_rows, dtype=torch.bool,
                                  device=dev) for dev in self.mesh.slots]

    def _set_tombstones(self, ids, value: bool) -> None:
        """Set/clear tombstone bits for global row ids, in place on the
        mask of the slot that owns each.  O(changes), no rebuild."""
        if self.tombs is None:
            raise RuntimeError("build before tombstone updates")
        ids = np.atleast_1d(np.asarray(ids, np.int64))
        if not len(ids):
            return
        if (ids < 0).any() or (ids >= self.n).any():
            raise ValueError("tombstone ids out of range")
        span = self._slot_rows
        slot_of = ids // span
        for i in np.unique(slot_of):
            i = int(i)
            local = torch.from_numpy(ids[slot_of == i] - i * span)
            self.tombs[i].index_fill_(0, local.to(self.tombs[i].device),
                                      value)

    def mark_deleted(self, ids) -> None:
        """Tombstone global row ids across the shards — the sharded
        analogue of the single-device ``PartitionedIndex.mark_deleted``."""
        self._set_tombstones(ids, True)

    def mark_undeleted(self, ids) -> None:
        """Clear tombstones (the sharded analogue of the single-device
        undelete window — valid until the shard arenas compact/retire)."""
        self._set_tombstones(ids, False)

    # -- build ------------------------------------------------------------------

    def _build_tables(self, codes_parts: list) -> None:
        """Per-shard partition tables from each slot's resident codes
        ([rows/slot, G, W]), stacked per slot under a leading shard axis."""
        rows = self.shard_rows
        tables = []
        for codes in codes_parts:
            per_shard = []
            for lo in range(0, len(codes), rows):
                codes_s = codes[lo:lo + rows]
                keys_s = coding.keys_from_codes(codes_s)
                per_shard.append(partition.build_partitions(
                    keys_s.T.contiguous(),
                    codes_s.permute(1, 0, 2).contiguous(), self.block_size,
                    wide=self.wide_keys))
            tables.append(PartitionTable(*(
                None if fs[0] is None else torch.stack(fs)
                for fs in zip(*per_shard))))
        self.table = tables

    def build(self, base: np.ndarray, keep_base: bool = True,
              keep_codes: bool = False, keep_bits: bool = False,
              capacity: int | None = None) -> None:
        """Pad to the shard count, encode + build per-shard partitions.

        Layout: every array's leading-N axis is cut into the shards' row
        ranges, each slot's shards in one tensor on its device; group and
        partition axes stay local, so the build sort and all query gathers
        are shard-local (nothing crosses shards until the final merge).

        ``keep_base=False`` drops the plaintext corpus from the device after
        the routing tables are built — the ENCRYPTED serving mode: the
        device holds only LSH routing state (codes/keys/partitions, no
        vector content), exactly like the single-device index; refine
        happens on the host against the shard-aligned ciphertext stores.

        ``keep_codes=True`` additionally keeps each shard's per-point packed
        codes on the device for the full-code rerank stage (G*W words/point).

        ``capacity`` reserves row headroom beyond ``len(base)``: the pad
        region (masked at query time) doubles as live-insert capacity for
        :meth:`append_scan_rows`.
        """
        n = len(base)
        nd = self.n_devices
        rows = -(-max(n, capacity or 0) // nd)
        pad = rows * nd - n
        if pad:
            # pad with copies of the last row; padded row ids are masked out
            base = np.concatenate([base, np.repeat(base[-1:], pad, 0)])
        self.n = n
        self.shard_rows = rows
        base = np.ascontiguousarray(base, np.float32)
        span = self._slot_rows
        base_parts, codes_parts = [], []
        for i, dev in enumerate(self.mesh.slots):
            part = torch.from_numpy(base[i * span:(i + 1) * span]).to(dev)
            bank = self._banks[dev]
            codes = torch.empty((span, bank.g, bank.code_words),
                                dtype=torch.int32, device=dev)
            for lo in range(0, span, rows):
                codes[lo:lo + rows].copy_(
                    coding.encode(part[lo:lo + rows], bank)[0])
            base_parts.append(part)
            codes_parts.append(codes)
        self._build_tables(codes_parts)
        self._init_tombs()
        self.point_codes = codes_parts if keep_codes else None
        self.base = base_parts if keep_base else None
        self._set_scan_arrays(codes_parts, keep_bits)

    def build_stream(self, chunks, n_total: int, keep_codes: bool = False,
                     keep_bits: bool = False,
                     capacity: int | None = None) -> int:
        """Streaming build: consume an iterator of [b, d] f32 chunks and
        NEVER materialize the corpus (reference ingestion is a streaming
        loop, ForwardSecureANNSystem.java:438-479; the one-shot ``build``
        pads and uploads the whole corpus).

        Each chunk is sliced at shard-row boundaries, each slice shipped to
        the device of the slot that owns its rows and encoded there
        (device-consistent with query-time encoding — bit-identical codes),
        and the raw slice is dropped; host peak memory is one chunk, device
        peak is the codes.  The codes land in their shard's range of the
        slot's array and the per-shard partition build runs exactly like
        the one-shot path.
        """
        nd = self.n_devices
        rows = -(-max(n_total, capacity or 0) // nd)
        self.n = n_total
        self.shard_rows = rows
        span = self._slot_rows
        g, w = self.bank.g, self.bank.code_words
        # zero rows past the stream's end: the tail shard's pad, masked at
        # query time (rows >= n)
        codes_parts = [torch.zeros((span, g, w), dtype=torch.int32,
                                   device=dev) for dev in self.mesh.slots]
        pos = 0
        for c in chunks:
            c = np.ascontiguousarray(c, np.float32)
            o = 0
            while o < len(c):
                s = (pos + o) // rows
                if s >= nd:
                    raise ValueError(
                        f"stream longer than n_total={n_total}")
                take = min(len(c) - o, (s + 1) * rows - (pos + o))
                i = s // self.mesh.shards_per_slot
                dev = self.mesh.slots[i]
                codes_s, _ = coding.encode(
                    torch.from_numpy(c[o:o + take]).to(dev), self._banks[dev])
                hamming_scan.update_rows(codes_parts[i], codes_s,
                                         pos + o - i * span)
                o += take
            pos += len(c)
        if pos != n_total:
            raise ValueError(f"stream provided {pos} rows, "
                             f"expected n_total={n_total}")
        self._build_tables(codes_parts)
        self._init_tombs()
        self.base = None
        self.point_codes = codes_parts if keep_codes else None
        self._set_scan_arrays(codes_parts, keep_bits)
        return pos

    def _set_scan_arrays(self, codes_parts: list, keep_bits) -> None:
        """Materialize each slot's scan state from its resident packed
        codes in the requested layout: True = unpacked int8 bit matrix
        (built block by block into one preallocated tensor), "packed" =
        keep the int32 words, False = none.  Popcounts come from the words
        (pad bits are zero by the packers' contract, ops/coding.py
        pack_codes)."""
        self.bits = self.words = self.popc = None
        if not keep_bits:
            return
        self.popc = [hamming_scan._popcounts(c, _UNPACK_CHUNK)
                     for c in codes_parts]
        if keep_bits == "packed":
            self.words = codes_parts
            return
        cb = self.bank.code_bits
        bits_parts = []
        for codes in codes_parts:
            bits = torch.empty((len(codes), self.bank.g * cb),
                               dtype=torch.int8, device=codes.device)
            for lo in range(0, len(codes), _UNPACK_CHUNK):
                bits[lo:lo + _UNPACK_CHUNK] = \
                    hamming_scan.unpack_bits_device(
                        codes[lo:lo + _UNPACK_CHUNK], cb)
            bits_parts.append(bits)
        self.bits = bits_parts

    # -- checkpoint / restore ----------------------------------------------------

    def save_state(self, path: str) -> None:
        """Persist the routing state: per-point packed codes + bank +
        geometry.  The sharded analogue of the single-device table
        checkpoint (index/service.save_table): codes are the generator of
        every routing structure (tables/bits rebuild deterministically), so
        the checkpoint is N·G·W words instead of all derived state.  The
        slots are copied to the host one by one (:meth:`_gather_host`) and
        the file does not depend on the slot count.

        The file holds the JAX package's keys and, beside them, ``alpha``
        (the JAX package regenerates it from the seed; either file
        restores here)."""
        codes = self.point_codes if self.point_codes is not None \
            else self.words
        if codes is None and self.bits is None:
            raise RuntimeError("nothing to save: build with keep_codes or "
                               "keep_bits first")
        if codes is not None:
            codes_np = self._gather_host(codes).view(np.uint32)
        else:
            # scan-only build: repack the bit matrix (lossless)
            bits = self._gather_host(self.bits).view(np.uint8)  # [N_pad, B]
            g, cb = self.bank.g, self.bank.code_bits
            w = self.bank.code_words
            by = np.packbits(
                np.pad(bits.reshape(len(bits), g, cb),
                       ((0, 0), (0, 0), (0, w * 32 - cb))), axis=-1)
            codes_np = by.view(">u4").astype(np.uint32).reshape(
                len(bits), g, w)
        tmp = path + ".tmp"
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        np.savez(tmp, codes=codes_np, n=self.n, shard_rows=self.shard_rows,
                 ndev=self.n_devices, block=self.block_size,
                 wide=self.wide_keys,
                 omega=np.asarray(self.bank.omega), r=np.asarray(self.bank.r),
                 m=self.bank.m, lam=self.bank.lam, tables=self.bank.tables,
                 divisions=self.bank.divisions, seed=self.bank.seed,
                 dim=self.bank.d, alpha=np.asarray(self.bank.alpha))
        os.replace(tmp + ".npz", path)

    @classmethod
    def restore_state(cls, path: str, mesh: Mesh,
                      keep_codes: bool = False, keep_bits: bool = True
                      ) -> "ShardedIndex":
        """Rebuild a ShardedIndex from :meth:`save_state` — each slot's
        codes ship straight to its device (no re-encode, no plaintext) and
        tables/bits rebuild per shard.  Any slot count restores a file of
        the same shard count; a mesh of another shard count is refused.  A
        checkpoint without ``alpha`` (the JAX package's) regenerates it
        from the seed, as JAX's own restore does
        (``coding.bank_from_stats``)."""
        with np.load(path) as z:
            nd = int(z["ndev"])
            if mesh.n_shards != nd:
                raise ValueError(f"checkpoint is for {nd} devices, mesh has "
                                 f"{mesh.n_shards}")
            hyper = (int(z["m"]), int(z["lam"]), int(z["tables"]),
                     int(z["divisions"]), int(z["seed"]))
            if "alpha" in z.files:
                bank = coding.GBank(
                    z["alpha"].astype(np.float32), z["r"].astype(np.float32),
                    z["omega"].astype(np.float32), *hyper)
            else:
                bank = coding.bank_from_stats(z["omega"], z["r"],
                                              int(z["dim"]), *hyper)
            idx = cls(mesh, bank, block_size=int(z["block"]),
                      wide_keys=bool(z["wide"]) if "wide" in z.files
                      else False)
            idx.n = int(z["n"])
            idx.shard_rows = int(z["shard_rows"])
            codes_np = z["codes"].astype(np.uint32)
        span = idx._slot_rows
        codes_parts = [coding.words_to_torch(codes_np[i * span:(i + 1) * span],
                                             dev)
                       for i, dev in enumerate(mesh.slots)]
        del codes_np
        idx._build_tables(codes_parts)
        idx._init_tombs()
        idx.point_codes = codes_parts if keep_codes else None
        idx._set_scan_arrays(codes_parts, keep_bits)
        return idx

    # -- live insert (scan mode) -------------------------------------------------

    def append_scan_rows(self, vecs: np.ndarray) -> np.ndarray:
        """Live insert (scan mode) — the sharded analogue of the
        single-device ``PartitionedIndex.append_rows`` (index/service.py):
        encode the new rows on the device of the slot that owns them, write
        them IN PLACE into their shard's range of that slot's scan state
        (``hamming_scan.update_rows``: the tensors keep their storage), and
        bump ``n`` — the scan step reads the live row count at every call,
        so appended rows are searchable immediately.

        Capacity is the pad region reserved by ``build(capacity=...)`` /
        ``build_stream(capacity=...)``; appending past it raises.  Returns
        the assigned global row ids (the next ordinals — range placement
        demands contiguity)."""
        packed = self.words is not None
        if self.bits is None and not packed:
            raise RuntimeError("mesh live insert requires "
                               "build(keep_bits=True) (routing_mode='scan')")
        vecs = np.ascontiguousarray(vecs, np.float32)
        b = len(vecs)
        nd, rows = self.n_devices, self.shard_rows
        if self.n + b > rows * nd:
            raise RuntimeError(
                f"mesh capacity exhausted ({rows * nd} rows, {self.n} "
                "live) — rebuild with capacity headroom")
        cb = self.bank.code_bits
        span = self._slot_rows
        mats = self.words if packed else self.bits
        popcs = self.popc
        pos, o = self.n, 0
        while o < b:
            s = (pos + o) // rows
            off = (pos + o) - s * rows
            take = min(b - o, rows - off)
            i = s // self.mesh.shards_per_slot
            dev = self.mesh.slots[i]
            at = pos + o - i * span
            chunk = torch.from_numpy(vecs[o:o + take]).to(dev)
            codes_s, _ = coding.encode(chunk, self._banks[dev])
            hamming_scan.update_rows(
                mats[i], codes_s if packed
                else hamming_scan.unpack_bits_device(codes_s, cb), at)
            hamming_scan.update_rows(
                popcs[i], hamming_scan._popcounts(codes_s, _UNPACK_CHUNK), at)
            o += take
        # kept packed codes (rerank path) don't cover the appended rows —
        # drop them so save_state repacks from the (current) scan state
        # instead of checkpointing a stale code array
        self.point_codes = None
        ids = np.arange(self.n, self.n + b, dtype=np.int64)
        self.n += b
        return ids

    # -- query ------------------------------------------------------------------

    def _shard_cap(self, probe_shards: int | None) -> int:
        return self.n_devices if probe_shards is None \
            else max(1, min(probe_shards, self.n_devices))

    def _dead_rows(self, s: int, tombs_local: torch.Tensor, n_live: int,
                   shard_cap: int) -> torch.Tensor:
        """bool [rows]: shard ``s``'s tombstones, every row at or past the
        live count, and every row of an unprobed shard."""
        rows = self.shard_rows
        live = min(max(n_live - s * rows, 0), rows) if s < shard_cap else 0
        dead = tombs_local.clone()
        dead[live:] = True
        return dead

    def _queries(self, queries) -> torch.Tensor:
        """The queries as float32 on the first slot's device; host arrays
        go through pinned memory, so the upload does not wait either."""
        if isinstance(queries, torch.Tensor):
            return queries.to(device=self.device, dtype=torch.float32)
        q = torch.from_numpy(np.ascontiguousarray(queries, np.float32))
        if self.device.type == "cuda":
            q = q.pin_memory()
        return q.to(self.device, non_blocking=True)

    def _replicate(self, queries: torch.Tensor) -> dict:
        """The queries on every distinct device of the mesh (the JAX
        package's replicated ``P(None)`` queries): a peer copy to each
        device they are not on."""
        return {dev: queries.to(dev, non_blocking=True)
                for dev in self.mesh.devices}

    def _encode(self, replicas: dict) -> dict:
        """device → the queries' (codes, keys), encoded on that device from
        its replica (:meth:`_replicate`)."""
        return {dev: coding.encode(q, self._banks[dev])
                for dev, q in replicas.items()}

    def query_step_fn(self, probes: int, refinement_limit: int, k: int,
                      probe_shards: int | None = None):
        """Return the sharded query step (route → local refine → top-k
        merge over the shards, gathered onto the first slot's device):
        ``step(table, base, tombs, queries)``.

        ``probe_shards`` restricts results to the first N shards (reference
        ``-Dprobe.shards``, ForwardSecureANNSystem.java:1598-1617): the
        unprobed shards' rows are masked out of the merge.

        Ties in distance keep the lower candidate position (stable sorts),
        the order of the JAX package's ``lax.top_k``."""
        rows = self.shard_rows
        shard_cap = self._shard_cap(probe_shards)

        def step(table_stacked, base, tombs, queries):
            qs = self._replicate(queries)
            enc = self._encode(qs)
            ids_blocks, d2_blocks = [], []
            for s in range(self.n_devices):
                dev = self._slot_device(s)
                qcodes, qkeys = enc[dev]
                tomb = self._dead_rows(s, self._shard(tombs, s), self.n,
                                       shard_cap)
                routed = routing.route(self._shard_table(table_stacked, s),
                                       qcodes, qkeys, tomb, probes,
                                       refinement_limit)
                cand = routed.ids                                # local rows
                safe = torch.clamp(cand, min=0).to(torch.int64)
                cand_vecs = self._shard(base, s)[safe]           # [Q, R, d]
                diff = cand_vecs - qs[dev][:, None, :]
                d2 = (diff * diff).sum(dim=-1)
                d2 = torch.where(cand >= 0, d2,
                                 torch.full_like(d2, 3.4e38))
                kk = min(k, cand.shape[-1])
                d2, idx = torch.sort(d2, dim=-1, stable=True)
                d2, idx = d2[:, :kk], idx[:, :kk]
                local_ids = cand.gather(-1, idx)
                ids_blocks.append(torch.where(
                    local_ids >= 0, local_ids + s * rows,
                    torch.full_like(local_ids, -1)))
                d2_blocks.append(d2)
            # ---- merge of the shards' tiny top-K blocks ----
            all_ids = _gather(ids_blocks, self.device)           # [Q, n*K]
            all_d2 = _gather(d2_blocks, self.device)
            md2, midx = torch.sort(all_d2, dim=-1, stable=True)
            md2, midx = md2[:, :k], midx[:, :k]
            out_ids = all_ids.gather(-1, midx)
            dist = torch.sqrt(torch.clamp(md2, min=0.0))
            dist = torch.where(out_ids >= 0, dist,
                               torch.full_like(dist, float("inf")))
            return out_ids, dist

        return step

    def route_step_fn(self, probes: int, refinement_limit: int,
                      probe_shards: int | None = None,
                      rerank_limit: int = 0):
        """Route-ONLY sharded step for encrypted serving: per-shard
        multi-probe routing, global-id conversion, merge of the per-shard
        ranked (id, score) blocks by Hamming score on the first slot's
        device: ``step(table, tombs, queries[, point_codes])``.  No vector
        content touches the device — the candidate ids go back to the host
        for decrypt+refine against the shard-aligned ciphertext arenas.

        ``rerank_limit > 0`` (needs build(keep_codes=True)) re-scores each
        shard's routed set by exact full-code Hamming
        (ops/routing.route_rerank: one ``code_hamming`` launch per shard and
        batch, on the shard's device) and truncates LOCALLY before the
        merge — the global top-L by fine score is contained in the union of
        per-shard top-Ls, so the merge is exact while its payload shrinks
        from refinement_limit to rerank_limit per shard."""
        rows = self.shard_rows
        limit = refinement_limit
        shard_cap = self._shard_cap(probe_shards)
        use_rerank = rerank_limit > 0
        if use_rerank and self.point_codes is None:
            raise RuntimeError("rerank requires build(keep_codes=True)")

        def step(table_stacked, tombs, queries, *maybe_codes):
            enc = self._encode(self._replicate(queries))
            ids_blocks, sc_blocks = [], []
            for s in range(self.n_devices):
                qcodes, qkeys = enc[self._slot_device(s)]
                table = self._shard_table(table_stacked, s)
                dead_rows = self._dead_rows(s, self._shard(tombs, s), self.n,
                                            shard_cap)
                if use_rerank:
                    routed = routing.route_rerank(
                        table, qcodes, qkeys, dead_rows,
                        self._shard(maybe_codes[0], s), probes, rerank_limit)
                else:
                    routed = routing.route(table, qcodes, qkeys, dead_rows,
                                           probes, limit)
                live = routed.ids >= 0
                pad = torch.full_like(routed.ids, INT32_MAX)
                ids_blocks.append(torch.where(live, routed.ids + s * rows,
                                              pad))
                sc_blocks.append(torch.where(live, routed.scores, pad))
            return _merge_device(ids_blocks, sc_blocks,
                                 rerank_limit if use_rerank else limit,
                                 self.device)

        return step

    def _scan_blocks(self, local_topl, qbits: dict, limit: int, merge: str):
        """Run ``local_topl(s, dev)`` → (rank int32 [Q, k], row int32 [Q, k],
        dead = (_DEAD, -1)) over the shards, each on its slot's device, and
        merge: global ids, fine scores (rank + the query's popcount),
        INT32_MAX pads.  ``merge="host"`` returns each slot's blocks side by
        side (a list with one tensor a slot) for :func:`host_merge_topl`."""
        rows = self.shard_rows
        ids_blocks, sc_blocks = [], []
        for s in range(self.n_devices):
            dev = self._slot_device(s)
            best_sc, best_id = local_topl(s, dev)
            qpopc = qbits[dev][1]
            live = best_sc < _DEAD
            pad = torch.full_like(best_sc, INT32_MAX)
            ids_blocks.append(torch.where(live, best_id + s * rows, pad))
            sc_blocks.append(torch.where(live, best_sc + qpopc[:, None], pad))
        if merge == "host":
            spp = self.mesh.shards_per_slot

            def per_slot(blocks):
                return [torch.cat(blocks[lo:lo + spp], dim=1)
                        for lo in range(0, self.n_devices, spp)]

            return per_slot(ids_blocks), per_slot(sc_blocks)
        return _merge_device(ids_blocks, sc_blocks, limit, self.device)

    def _no_live_row(self, q: int, k: int, device: torch.device):
        """The local top-k of a shard that is not scanned: all dead."""
        return (torch.full((q, k), _DEAD, dtype=torch.int32, device=device),
                torch.full((q, k), -1, dtype=torch.int32, device=device))

    def _query_bits(self, queries: torch.Tensor, device: torch.device):
        """The queries' code bits (int8 [Q, B]) and popcounts, encoded ON
        ``device`` (unlike the single-device scan point, which encodes on
        the host)."""
        qcodes, _ = coding.encode(queries.to(device, non_blocking=True),
                                  self._banks[device])
        qbits = hamming_scan.unpack_bits_device(qcodes, self.bank.code_bits)
        return qbits, qbits.to(torch.int32).sum(dim=1, dtype=torch.int32)

    def scan_route_step_fn(self, limit: int, probe_shards: int | None = None,
                           approx: bool = True, merge: str = "ici"):
        """Hamming scan over the shards: per-shard int8 bit product + local
        top-L on the shard's device, then the exact merge by fine score
        (global top-L ⊆ union of per-shard top-Ls): ``step(bits, popc,
        tombs, queries, n_live)``.  The merged payload is L ids+scores per
        shard — no vector content, no codes.

        ``merge="host"`` returns the per-shard top-Ls side by side ([Q,
        n*k] per slot) and :func:`host_merge_topl` does the same exact
        2-key merge on the host — bit-identical results.  A shard with no
        live row (past ``n_live``, or unprobed) is not scanned: its block
        is all pads.  ``approx`` selects each shard's top-L approximately
        over its rows."""
        rows = self.shard_rows
        shard_cap = self._shard_cap(probe_shards)
        k = min(limit, rows)

        def step(bits, popc, tombs, queries, n_live):
            qbits = {dev: self._query_bits(queries, dev)
                     for dev in self.mesh.devices}
            q = queries.shape[0]

            def local_topl(s, dev):
                if s >= shard_cap or s * rows >= n_live:
                    return self._no_live_row(q, k, dev)
                dead = self._dead_rows(s, self._shard(tombs, s), n_live,
                                       shard_cap)
                return hamming_scan._select(
                    hamming_scan._bit_dots(qbits[dev][0],
                                           self._shard(bits, s)),
                    self._shard(popc, s), dead, k, 0, approx)

            return self._scan_blocks(local_topl, qbits, limit, merge)

        return step

    def scan_route_step_fn_packed(self, limit: int,
                                  probe_shards: int | None = None,
                                  approx: bool = True, chunk: int = 1 << 19,
                                  merge: str = "ici"):
        """Packed-layout sharded scan: each shard runs the chunked
        running-top-L loop of the single-device scan
        (``hamming_scan.scan_chunks``) over its view of the words — slice
        ``chunk`` packed rows, their bit products straight from the words,
        2-key merge — so only the [Q, chunk] products exist at a time on
        each device (the resident state is the 8×-smaller word matrix).
        Merge identical to the unpacked step."""
        rows = self.shard_rows
        shard_cap = self._shard_cap(probe_shards)
        chunk = min(chunk, rows)
        k = min(limit, chunk)

        def step(words, popc, tombs, queries, n_live):
            qbits = {dev: self._query_bits(queries, dev)
                     for dev in self.mesh.devices}
            q = queries.shape[0]

            def local_topl(s, dev):
                if s >= shard_cap or s * rows >= n_live:
                    return self._no_live_row(q, k, dev)
                dead = self._dead_rows(s, self._shard(tombs, s), n_live,
                                       shard_cap)
                return hamming_scan.scan_chunks(
                    self._shard(words, s), self._shard(popc, s), dead,
                    qbits[dev][0], limit, chunk, approx=approx)

            return self._scan_blocks(local_topl, qbits, limit, merge)

        return step

    def scan_route_dispatch(self, queries: np.ndarray, limit: int = 2048,
                            probe_shards: int | None = None,
                            approx: bool = True) -> _Dispatched:
        """Non-blocking stage-A dispatch: the step is queued on every
        slot's device and the result's copy to pinned host memory started;
        ``.get()`` waits for it (and, with ``merge_backend="host"``, merges
        the shards' blocks on the host)."""
        packed = self.words is not None
        if self.bits is None and not packed:
            raise RuntimeError("scan requires build(keep_bits=True)")
        mk = self.scan_route_step_fn_packed if packed \
            else self.scan_route_step_fn
        step = mk(limit, probe_shards, approx, merge=self.merge_backend)
        ids, sc = step(self.words if packed else self.bits, self.popc,
                       self.tombs, self._queries(queries), self.n)
        if self.merge_backend == "host":
            return _Dispatched(ids, sc, limit)
        return _Dispatched([ids], [sc])

    def scan_route(self, queries: np.ndarray, limit: int = 2048,
                   probe_shards: int | None = None, approx: bool = True):
        """Stage A via the sharded Hamming scan (needs build(keep_bits=True)
        or the packed layout, keep_bits="packed")."""
        return self.scan_route_dispatch(queries, limit, probe_shards,
                                        approx).get()

    def route_dispatch(self, queries: np.ndarray, probes: int = 5,
                       refinement_limit: int = 2048,
                       probe_shards: int | None = None,
                       rerank_limit: int = 0) -> _Dispatched:
        """Non-blocking probe-route dispatch (host copy started)."""
        step = self.route_step_fn(probes, refinement_limit, probe_shards,
                                  rerank_limit)
        args = (self.table, self.tombs, self._queries(queries))
        if rerank_limit > 0:
            args += (self.point_codes,)
        ids, sc = step(*args)
        return _Dispatched([ids], [sc])

    def route(self, queries: np.ndarray, probes: int = 5,
              refinement_limit: int = 2048,
              probe_shards: int | None = None,
              rerank_limit: int = 0):
        """Candidate generation across the shards (encrypted serving stage
        A): ranked global candidate ids [Q, R] (-1 pad) + Hamming scores."""
        return self.route_dispatch(queries, probes, refinement_limit,
                                   probe_shards, rerank_limit).get()

    def query(self, queries: np.ndarray, probes: int = 5,
              refinement_limit: int = 2048, k: int = 10,
              probe_shards: int | None = None):
        if self.base is None:
            raise RuntimeError(
                "plaintext refine unavailable: index built with "
                "keep_base=False (encrypted mode) — use route() + host "
                "decrypt/refine")
        step = self.query_step_fn(probes, refinement_limit, k, probe_shards)
        ids, dist = step(self.table, self.base, self.tombs,
                         self._queries(queries))
        return ids.cpu().numpy(), dist.cpu().numpy()
