"""Multi-dimension system: one facade per vector dimensionality, shared keys.

Reference counterpart: the reference facade keeps per-dimension token
factories and index states in one object
(``ForwardSecureANNSystem.java:360-375``, ``DimensionState[]`` keyed by dim).
Here each dimension gets its own sub-system (store + index + query service)
under one keystore and one rotation policy, so key rotation is global while
routing/storage stay per-dim — the same observable behavior.
"""

from __future__ import annotations

import os

import numpy as np

from ..config import SystemConfig
from ..crypto.keys import KeyManager
from .system import ForwardSecureANNSystem


class MultiDimSystem:
    def __init__(self, cfg: SystemConfig, base_dir: str,
                 query_batch: int = 64, device=None):
        self.cfg = cfg
        self.device = device
        self.base_dir = base_dir
        self.query_batch = query_batch
        os.makedirs(base_dir, exist_ok=True)
        # shared keystore for every dimension
        self.km = KeyManager(os.path.join(base_dir, "keystore.blob"),
                             retention_max=cfg.keys.retention_max)
        self._systems: dict[int, ForwardSecureANNSystem] = {}

    def system_for(self, dim: int) -> ForwardSecureANNSystem:
        sys_ = self._systems.get(dim)
        if sys_ is None:
            sub = os.path.join(self.base_dir, f"d{dim}")
            # constructor-inject the shared keystore: every sub-component
            # (store, rotation, background daemon, token factory) captures
            # the one KeyManager at construction — nothing to re-point, no
            # component can be left holding a throwaway keystore
            sys_ = ForwardSecureANNSystem(self.cfg, sub, dim,
                                          self.query_batch,
                                          key_manager=self.km,
                                          device=self.device)
            self._systems[dim] = sys_
        return sys_

    @property
    def dims(self) -> list[int]:
        return sorted(self._systems)

    def batch_insert(self, ids, vecs) -> None:
        vecs = np.asarray(vecs, np.float32)
        self.system_for(vecs.shape[1]).batch_insert(ids, vecs)

    def finalize_for_search(self) -> None:
        for sys_ in self._systems.values():
            sys_.finalize_for_search()

    def create_token(self, query, top_k: int):
        query = np.asarray(query, np.float32)
        return self.system_for(query.shape[-1]).create_token(query, top_k)

    def search(self, token):
        return self.system_for(token.dimension).search(token)

    def run_selective_reencryption(self) -> dict:
        """Global rotation, per-dim migration of each dim's touched set.

        The rotation goes THROUGH a sub-system's KeyRotationService (not
        ``km.rotate()`` directly) so pin/freeze are honored: a restored,
        version-pinned sub-system refuses global rotation instead of being
        rotated out from under its pin."""
        for dim, sys_ in self._systems.items():
            rot = sys_.rotation
            if rot.rotation_frozen or rot.pinned_version is not None:
                return {"skipped": True,
                        "reason": f"dimension {dim} rotation pinned/frozen"}
        old = self.km.current_version
        first = next(iter(self._systems.values()), None)
        if first is None:
            self.km.rotate()   # no sub-systems yet: nothing pinned
        else:
            first.rotation.force_rotate_now()
        out = {"old_version": old, "new_version": self.km.current_version,
               "per_dim": {}}
        for dim, sys_ in self._systems.items():
            touched = sys_.tracker.drain()
            row = sys_.reenc_coordinator.run_once_with_version(
                self.km.current_version, touched)
            out["per_dim"][dim] = row
        return out

    def restore_all(self) -> dict[int, int]:
        """Discover per-dimension stores on disk (d<dim>/ subdirs) and
        restore each (reference query-only mode across DimensionStates)."""
        restored = {}
        for name in sorted(os.listdir(self.base_dir)):
            if not (name.startswith("d") and name[1:].isdigit()):
                continue
            dim = int(name[1:])
            restored[dim] = self.system_for(dim).restore_index_from_disk()
        return restored

    def shutdown(self) -> None:
        for sys_ in self._systems.values():
            sys_.shutdown()
