"""Path registry: env/property-driven storage locations.

Reference counterpart: ``common/FsPaths.java`` (:9-14) — a system-property/
env registry for ``fspann.baseDir``, ``metadata.dbDir``, ``pointsDir``,
``keys.storeFile``, ``logs.dir``.  Here the same override surface reads
``FSPANN_*`` environment variables with base-dir-relative defaults.
"""

from __future__ import annotations

import os


class FsPaths:
    def __init__(self, base_dir: str | None = None):
        self.base_dir = (base_dir
                         or os.environ.get("FSPANN_BASE_DIR")
                         or "./fspann_data")

    def _env_or(self, env: str, default_rel: str) -> str:
        v = os.environ.get(env)
        return v if v else os.path.join(self.base_dir, default_rel)

    @property
    def metadata_log(self) -> str:
        return self._env_or("FSPANN_METADATA_LOG", "meta.log")

    @property
    def points_dir(self) -> str:
        return self._env_or("FSPANN_POINTS_DIR", "points")

    @property
    def keystore_file(self) -> str:
        return self._env_or("FSPANN_KEYSTORE", "keystore.blob")

    @property
    def bank_file(self) -> str:
        return self._env_or("FSPANN_BANK", "bank.npz")

    @property
    def logs_dir(self) -> str:
        return self._env_or("FSPANN_LOGS_DIR", "logs")

    @property
    def results_dir(self) -> str:
        return self._env_or("FSPANN_RESULTS_DIR", "results")

    def ensure(self) -> "FsPaths":
        os.makedirs(self.base_dir, exist_ok=True)
        os.makedirs(self.points_dir, exist_ok=True)
        return self
