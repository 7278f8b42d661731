"""Transaction machinery re-exports (reference: transaction/__init__.py)."""

from mythril_tpu_torch.laser.ethereum.transaction.transaction_models import (  # noqa: F401
    BaseTransaction,
    ContractCreationTransaction,
    MessageCallTransaction,
    TransactionEndSignal,
    TransactionStartSignal,
    get_next_transaction_id,
    reset_transaction_ids,
)
from mythril_tpu_torch.laser.ethereum.transaction.symbolic import (  # noqa: F401
    ACTORS,
    Actors,
    execute_contract_creation,
    execute_message_call,
)
