"""Framework-level exceptions (reference: mythril/exceptions.py; own copy
of the JAX package's)."""


class MythrilBaseException(Exception):
    """Base class for all framework errors."""


class CompilerError(MythrilBaseException):
    """Solidity compilation failed (or no compiler is available)."""


class UnsatError(MythrilBaseException):
    """No model exists for the queried constraints (or solver gave up)."""


class NoContractFoundError(MythrilBaseException):
    """Input file contained no contract."""


class CriticalError(MythrilBaseException):
    """Fatal user-facing error (bad input, bad flags, ...)."""


class AddressNotFoundError(MythrilBaseException):
    """On-chain address lookup failed."""


class DetectorNotFoundError(CriticalError):
    """Unknown detection-module name passed to the module loader."""


class LoaderError(CriticalError):
    """Input-loading failure with a machine-readable ``code``: the CLI
    maps these to a one-line structured error on stderr and exit 2,
    never a traceback.  Subclasses pin the code so scripts can branch
    on it."""

    code = "loader_error"

    def to_line(self) -> str:
        """One-line structured rendering (stable key order)."""
        import json

        return json.dumps(
            {"error": self.code, "detail": str(self)}, sort_keys=True
        )


class BadAddressError(LoaderError):
    """Malformed or checksum-failing contract address."""

    code = "bad_address"


class EmptyCodeError(LoaderError):
    """``eth_getCode`` answered ``0x``: no contract at that address."""

    code = "empty_code"


class BytecodeInputError(LoaderError):
    """Input is not hex-encoded bytecode (triage's only rejection)."""

    code = "bad_bytecode"


class ProviderExhaustedError(LoaderError):
    """Every RPC provider in the pool is down or rate-limiting (all
    circuit breakers open): retrying cannot help until one cools."""

    code = "provider_exhausted"
