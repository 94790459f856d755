"""Runtime config (runtime_config.yaml): dataDirectory, api port.

Parity with reference src/silo_api/runtime_config.cpp (dataDirectory,
overridable by --dataDirectory; default ./output/).
"""

from __future__ import annotations

import os
from dataclasses import dataclass

import yaml

DEFAULT_DATA_DIRECTORY = "./output/"


@dataclass
class RuntimeConfig:
    data_directory: str = DEFAULT_DATA_DIRECTORY
    port: int = 8081

    @classmethod
    def read(cls, path: str | None) -> "RuntimeConfig":
        config = cls()
        if path and os.path.exists(path):
            with open(path) as f:
                data = yaml.safe_load(f) or {}
            if data.get("dataDirectory"):
                config.data_directory = data["dataDirectory"]
            if data.get("port"):
                config.port = int(data["port"])
        return config
