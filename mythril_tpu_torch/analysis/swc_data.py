"""SWC registry ids and titles (reference: mythril/analysis/swc_data.py)."""

REENTRANCY = "107"
WRITE_TO_ARBITRARY_STORAGE = "124"
UNPROTECTED_ETHER_WITHDRAWAL = "105"
INTEGER_OVERFLOW_AND_UNDERFLOW = "101"
UNPROTECTED_SELFDESTRUCT = "106"
UNCHECKED_RET_VAL = "104"
DELEGATECALL_TO_UNTRUSTED_CONTRACT = "112"
MULTIPLE_SENDS = "113"
TX_ORIGIN_USAGE = "115"
DOS_WITH_BLOCK_GAS_LIMIT = "128"
TIMESTAMP_DEPENDENCE = "116"
WEAK_RANDOMNESS = "120"
ASSERT_VIOLATION = "110"
ARBITRARY_JUMP = "127"

SWC_TO_TITLE = {
    "100": "Function Default Visibility",
    "101": "Integer Overflow and Underflow",
    "102": "Outdated Compiler Version",
    "103": "Floating Pragma",
    "104": "Unchecked Call Return Value",
    "105": "Unprotected Ether Withdrawal",
    "106": "Unprotected SELFDESTRUCT Instruction",
    "107": "Reentrancy",
    "108": "State Variable Default Visibility",
    "109": "Uninitialized Storage Pointer",
    "110": "Assert Violation",
    "111": "Use of Deprecated Solidity Functions",
    "112": "Delegatecall to Untrusted Callee",
    "113": "DoS with Failed Call",
    "114": "Transaction Order Dependence",
    "115": "Authorization through tx.origin",
    "116": "Block values as a proxy for time",
    "117": "Signature Malleability",
    "118": "Incorrect Constructor Name",
    "119": "Shadowing State Variables",
    "120": "Weak Sources of Randomness from Chain Attributes",
    "121": "Missing Protection against Signature Replay Attacks",
    "122": "Lack of Proper Signature Verification",
    "123": "Requirement Violation",
    "124": "Write to Arbitrary Storage Location",
    "125": "Incorrect Inheritance Order",
    "126": "Insufficient Gas Griefing",
    "127": "Arbitrary Jump with Function Type Variable",
    "128": "DoS With Block Gas Limit",
    "129": "Typographical Error",
    "130": "Right-To-Left-Override control character (U+202E)",
    "131": "Presence of unused variables",
    "132": "Unexpected Ether balance",
    "133": "Hash Collisions With Multiple Variable Length Arguments",
}
