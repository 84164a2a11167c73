"""Managed data workflows (a copy of ``dispatches_tpu/workflow/managed.py``).

Capability counterpart of the reference's ``workflow/workflow.py``
(:23-101): ``ManagedWorkflow`` memoizes datasets created through
``DatasetFactory``; the "rts-gmlc" dataset type resolves the RTS-GMLC
data directory (this build has zero network egress, so instead of the
reference's downloader wrapper (``rts_gmlc.py:21-26``) it accepts a
local path or the ``DISPATCHES_TPU_RTS_GMLC`` environment variable) and
the "null" type mirrors the reference's placeholder.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Optional


def rts_gmlc_dir(path: Optional[str] = None) -> Path:
    """Resolve a local RTS-GMLC dataset directory (the no-egress
    counterpart of the reference's ``rts_gmlc.download()``)."""
    p = path or os.environ.get("DISPATCHES_TPU_RTS_GMLC")
    if p is None:
        raise FileNotFoundError(
            "no RTS-GMLC directory: pass path= or set DISPATCHES_TPU_RTS_GMLC "
            "(this build cannot download; zero network egress)"
        )
    p = Path(p)
    if not p.is_dir():
        raise FileNotFoundError(f"RTS-GMLC directory {p} does not exist")
    return p


class Dataset:
    def __init__(self, name):
        self.name = name
        self._meta = {}

    @property
    def meta(self):
        return self._meta.copy()

    def add_meta(self, key, value):
        self._meta[key] = value

    def __str__(self):
        lines = ["Metadata", "--------"]
        for key, value in self._meta.items():
            lines.append(f"{key}:")
            lines.append(str(value))
        return "\n".join(lines)


class DatasetFactory:
    def __init__(self, type_, workflow=None):
        self._wf = workflow
        try:
            self.create = self._get_factory_function(type_)
        except KeyError:
            raise KeyError(f"Cannot create dataset of type '{type_}'")

    @classmethod
    def _get_factory_function(cls, name):
        if name == "rts-gmlc":

            def local_fn(**kwargs):
                d = rts_gmlc_dir(kwargs.get("path"))
                dataset = Dataset(name)
                dataset.add_meta("directory", d)
                dataset.add_meta("files", os.listdir(d))
                return dataset

            return local_fn
        if name == "null":

            def fn(**kwargs):
                return None

            return fn
        raise KeyError(name)


class ManagedWorkflow:
    def __init__(self, name, workspace_name):
        self._name = name
        self._workspace_name = workspace_name
        self._datasets = {}

    @property
    def name(self):
        return self._name

    @property
    def workspace_name(self):
        return self._workspace_name

    def get_dataset(self, type_, **kwargs):
        """Creates and returns a dataset of the specified type; memoized
        per type (reference ``workflow.py:38-49``)."""
        ds = self._datasets.get(type_, None)
        if ds is not None:
            return ds
        dsf = DatasetFactory(type_, workflow=self)
        ds = dsf.create(**kwargs)
        self._datasets[type_] = ds
        return ds
