"""Config handling: ~/.mythril_tpu/config.ini, RPC and LevelDB setup (own
copy of ``mythril_tpu/mythril/mythril_config.py``; reference:
mythril/mythril/mythril_config.py).  The directory and the file are the
JAX package's (``MYTHRIL_DIR`` overrides the directory), so both
packages read one configuration."""

import configparser
import logging
import os
from pathlib import Path
from typing import Optional

from mythril_tpu_torch.ethereum.interface.rpc.client import EthJsonRpc
from mythril_tpu_torch.exceptions import CriticalError

log = logging.getLogger(__name__)


class MythrilConfig:
    def __init__(self):
        self.mythril_dir = self._init_mythril_dir()
        self.config_path = os.path.join(self.mythril_dir, "config.ini")
        self.leveldb_dir = None
        self._init_config()
        self.eth: Optional[EthJsonRpc] = None
        self.eth_db = None

    def set_api_leveldb(self, leveldb_path: str) -> None:
        """Open a geth LevelDB for direct (offline) chain access."""
        from mythril_tpu_torch.ethereum.interface.leveldb.client import (
            EthLevelDB,
        )

        self.eth_db = EthLevelDB(leveldb_path)

    @staticmethod
    def _init_mythril_dir() -> str:
        try:
            mythril_dir = os.environ["MYTHRIL_DIR"]
        except KeyError:
            mythril_dir = os.path.join(os.path.expanduser("~"), ".mythril_tpu")
        if not os.path.exists(mythril_dir):
            log.info("Creating mythril data directory")
            os.makedirs(mythril_dir, exist_ok=True)
        return mythril_dir

    def _init_config(self) -> None:
        """Create the default config.ini on first run."""
        if not os.path.exists(self.config_path):
            log.info("No config file found. Creating default: %s", self.config_path)
            Path(self.config_path).touch()
        config = configparser.ConfigParser(allow_no_value=True)
        config.optionxform = str  # type: ignore[assignment]
        config.read(self.config_path, "utf-8")
        if "defaults" not in config.sections():
            self._add_default_options(config)
        if not config.has_option("defaults", "dynamic_loading"):
            self._add_dynamic_loading_option(config)
        with open(self.config_path, "w", encoding="utf-8") as fp:
            config.write(fp)
        leveldb_fallback_dir = os.path.join(
            os.path.expanduser("~"), ".ethereum", "geth", "chaindata"
        )
        self.leveldb_dir = config.get(
            "defaults", "leveldb_dir", fallback=leveldb_fallback_dir
        )

    @staticmethod
    def _add_default_options(config: configparser.ConfigParser) -> None:
        config.add_section("defaults")

    @staticmethod
    def _add_dynamic_loading_option(config: configparser.ConfigParser) -> None:
        config.set(
            "defaults", "#Default chain access for dynamic loading", None
        )
        config.set("defaults", "#– use rpc:<host:port>, or 'infura-<net>'", None)
        config.set("defaults", "dynamic_loading", "infura")

    def set_api_rpc_infura(self, network: str = "mainnet") -> None:
        infura_id = os.environ.get("INFURA_ID")
        if not infura_id:
            raise CriticalError(
                "Infura access requires the INFURA_ID environment variable"
            )
        self.eth = EthJsonRpc(
            f"https://{network}.infura.io/v3/{infura_id}", None, True
        )

    def set_api_rpc(self, rpc: Optional[str] = None, rpctls: bool = False) -> None:
        # provider-pool routes: an explicit comma-separated --rpc spec
        # or the MYTHRIL_TPU_RPC_PROVIDERS fleet knob wrap every
        # endpoint behind circuit breakers + rate-limit-aware backoff
        # (ethereum/interface/rpc/client.py ProviderPool)
        pool_spec = None
        if rpc is not None and "," in rpc:
            pool_spec = rpc
        elif rpc is None and os.environ.get("MYTHRIL_TPU_RPC_PROVIDERS"):
            pool_spec = os.environ["MYTHRIL_TPU_RPC_PROVIDERS"]
        if pool_spec is not None:
            from mythril_tpu_torch.ethereum.interface.rpc.client import ProviderPool

            self.eth = ProviderPool.from_spec(pool_spec, tls=rpctls)
            log.info("Using RPC provider pool: %s", pool_spec)
            return
        if rpc is None or rpc == "ganache":
            rpc = "localhost:8545"
        if rpc.startswith("infura-"):
            self.set_api_rpc_infura(rpc[len("infura-"):])
            return
        try:
            host, port = (rpc.split(":") + ["8545"])[:2]
        except ValueError:
            raise CriticalError(f"Invalid RPC argument: {rpc}")
        self.eth = EthJsonRpc(host, int(port), rpctls)
        log.info("Using RPC settings: %s", rpc)

    def set_api_from_config_path(self) -> None:
        """Use the dynamic_loading setting from config.ini."""
        config = configparser.ConfigParser(allow_no_value=False)
        config.optionxform = str  # type: ignore[assignment]
        config.read(self.config_path, "utf-8")
        dynamic_loading = config.get(
            "defaults", "dynamic_loading", fallback="infura"
        )
        if dynamic_loading == "infura":
            try:
                self.set_api_rpc_infura()
            except CriticalError:
                log.debug("Infura not configured; on-chain access disabled")
        else:
            self.set_api_rpc(dynamic_loading)
