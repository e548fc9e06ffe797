"""Gas schedule (Frontier through Prague): a copy of
`ethrex_tpu/evm/gas.py` (derived from the EIPs).

The pre-Berlin fork variants form a per-fork `Schedule`
(`schedule_for`): EIP-150 repricing (Tangerine), EIP-160 EXP cost +
EIP-161 state clearing + EIP-170 code limit (Spurious Dragon), the three
SSTORE regimes before EIP-2929 (legacy, EIP-1283 Constantinople-only,
EIP-2200 Istanbul), EIP-1884 + EIP-2028 (Istanbul), and the pre-London
refund rules (cap gas/2, SELFDESTRUCT refund 24000)."""

from __future__ import annotations

import dataclasses
import functools

# base opcode costs
ZERO = 0
BASE = 2
VERYLOW = 3
LOW = 5
MID = 8
HIGH = 10
JUMPDEST = 1

KECCAK256 = 30
KECCAK256_WORD = 6
COPY_WORD = 3
LOG = 375
LOG_DATA = 8
LOG_TOPIC = 375
EXP = 10
EXP_BYTE = 50
MEMORY = 3
QUAD_DIVISOR = 512
BLOCKHASH = 20

# EIP-2929
COLD_ACCOUNT_ACCESS = 2600
WARM_ACCESS = 100
COLD_SLOAD = 2100

# SSTORE (EIP-2200/3529)
SSTORE_SET = 20000
SSTORE_RESET = 2900        # 5000 - COLD_SLOAD
SSTORE_CLEARS_REFUND = 4800  # EIP-3529
SSTORE_SENTRY = 2300

# calls
CALL_VALUE = 9000
CALL_STIPEND = 2300
NEW_ACCOUNT = 25000

# create
CREATE = 32000
CODE_DEPOSIT_BYTE = 200
INITCODE_WORD = 2          # EIP-3860
MAX_CODE_SIZE = 24576
MAX_INITCODE_SIZE = 49152

SELFDESTRUCT = 5000

# transaction
TX_BASE = 21000
TX_CREATE = 32000
TX_DATA_ZERO = 4
TX_DATA_NONZERO = 16       # EIP-2028
TX_ACCESS_LIST_ADDR = 2400
TX_ACCESS_LIST_SLOT = 1900
TX_FLOOR_TOKEN_COST = 10   # EIP-7623 (Prague)
PER_EMPTY_ACCOUNT_AUTH = 25000  # EIP-7702
PER_AUTH_BASE = 12500

# blobs (EIP-4844)
BLOB_GAS_PER_BLOB = 131072
TARGET_BLOB_GAS_PER_BLOCK = 393216
MIN_BLOB_BASE_FEE = 1
BLOB_BASE_FEE_UPDATE_FRACTION = 3338477
MAX_BLOB_GAS_PER_BLOCK = 786432

# legacy SSTORE (pre-net-metering) and pre-London refunds
SSTORE_LEGACY_SET = 20000
SSTORE_LEGACY_RESET = 5000
SSTORE_LEGACY_REFUND = 15000
SELFDESTRUCT_REFUND = 24000     # removed by EIP-3529 (London)


@dataclasses.dataclass(frozen=True)
class Schedule:
    """Fork-dependent costs and rules the interpreter consults.

    Berlin+ keeps using the EIP-2929 warm/cold constants directly; the
    flat access costs here only matter for `pre_berlin` schedules.
    """

    sload: int
    balance: int
    extcode: int            # EXTCODESIZE / EXTCODECOPY base
    extcodehash: int
    call: int
    selfdestruct: int
    exp_byte: int
    tx_nonzero: int
    tx_create: int          # 0 before Homestead (EIP-2)
    call_63_64: bool        # EIP-150 gas cap (Tangerine+)
    eip161: bool            # Spurious Dragon state-clearing rules
    max_code_size: int      # 0 = unlimited (pre-EIP-170)
    strict_deposit: bool    # Homestead+: OOG when deposit unaffordable
    sstore_regime: str      # "legacy" | "net1283" | "net2200" | "berlin"
    net_sload: int          # dirty-write / no-op cost for the net regimes
    sstore_clear_refund: int  # 15000 through Berlin; 4800 London+ (EIP-3529)
    refund_divisor: int     # 2 pre-London, 5 after (EIP-3529)
    selfdestruct_refund: int
    pre_berlin: bool


def _sched(**kw) -> Schedule:
    base = dict(sload=50, balance=20, extcode=20, extcodehash=400,
                call=40, selfdestruct=0, exp_byte=10, tx_nonzero=68,
                tx_create=0, call_63_64=False, eip161=False,
                max_code_size=0, strict_deposit=False,
                sstore_regime="legacy", net_sload=200, refund_divisor=2,
                sstore_clear_refund=SSTORE_LEGACY_REFUND,
                selfdestruct_refund=SELFDESTRUCT_REFUND, pre_berlin=True)
    base.update(kw)
    return Schedule(**base)


@functools.lru_cache(maxsize=None)
def schedule_for(fork) -> Schedule:
    from ..primitives.genesis import Fork

    if fork >= Fork.LONDON:
        return _sched(sstore_regime="berlin", refund_divisor=5,
                      sstore_clear_refund=SSTORE_CLEARS_REFUND,
                      selfdestruct_refund=0, tx_nonzero=16,
                      tx_create=TX_CREATE, call_63_64=True, eip161=True,
                      max_code_size=MAX_CODE_SIZE, strict_deposit=True,
                      exp_byte=50, pre_berlin=False)
    if fork >= Fork.BERLIN:
        return _sched(sstore_regime="berlin", tx_nonzero=16,
                      tx_create=TX_CREATE, call_63_64=True, eip161=True,
                      max_code_size=MAX_CODE_SIZE, strict_deposit=True,
                      exp_byte=50, pre_berlin=False)
    if fork >= Fork.ISTANBUL:
        return _sched(sload=800, balance=700, extcode=700, extcodehash=700,
                      call=700, selfdestruct=SELFDESTRUCT, exp_byte=50,
                      tx_nonzero=16, tx_create=TX_CREATE, call_63_64=True,
                      eip161=True, max_code_size=MAX_CODE_SIZE,
                      strict_deposit=True, sstore_regime="net2200",
                      net_sload=800)
    if fork >= Fork.CONSTANTINOPLE:
        # Constantinople activates EIP-1283 net metering; Petersburg
        # (= Constantinople-fix) retracts it
        regime = "net1283" if fork == Fork.CONSTANTINOPLE else "legacy"
        return _sched(sload=200, balance=400, extcode=700, call=700,
                      selfdestruct=SELFDESTRUCT, exp_byte=50,
                      tx_create=TX_CREATE, call_63_64=True, eip161=True,
                      max_code_size=MAX_CODE_SIZE, strict_deposit=True,
                      sstore_regime=regime)
    if fork >= Fork.SPURIOUS_DRAGON:
        return _sched(sload=200, balance=400, extcode=700, call=700,
                      selfdestruct=SELFDESTRUCT, exp_byte=50,
                      tx_create=TX_CREATE, call_63_64=True, eip161=True,
                      max_code_size=MAX_CODE_SIZE, strict_deposit=True)
    if fork >= Fork.TANGERINE:
        return _sched(sload=200, balance=400, extcode=700, call=700,
                      selfdestruct=SELFDESTRUCT, tx_create=TX_CREATE,
                      call_63_64=True, strict_deposit=True)
    if fork >= Fork.HOMESTEAD:
        return _sched(tx_create=TX_CREATE, strict_deposit=True)
    return _sched()


def memory_cost(size_words: int) -> int:
    return MEMORY * size_words + size_words * size_words // QUAD_DIVISOR


def memory_expansion(current_size: int, new_size: int) -> int:
    """Cost to expand memory from current to new byte size (word-aligned)."""
    if new_size <= current_size:
        return 0
    cur_w = (current_size + 31) // 32
    new_w = (new_size + 31) // 32
    return memory_cost(new_w) - memory_cost(cur_w)


def copy_cost(length: int) -> int:
    return COPY_WORD * ((length + 31) // 32)


def keccak_cost(length: int) -> int:
    return KECCAK256 + KECCAK256_WORD * ((length + 31) // 32)


def exp_cost(exponent: int, exp_byte: int = EXP_BYTE) -> int:
    if exponent == 0:
        return EXP
    return EXP + exp_byte * ((exponent.bit_length() + 7) // 8)


def init_code_cost(length: int) -> int:
    return INITCODE_WORD * ((length + 31) // 32)


def tx_data_cost(data: bytes,
                 nonzero_cost: int = TX_DATA_NONZERO) -> tuple[int, int]:
    """Returns (standard_cost, tokens) — tokens feed the EIP-7623 floor."""
    zeros = data.count(0)
    nonzeros = len(data) - zeros
    tokens = zeros + nonzeros * 4
    return TX_DATA_ZERO * zeros + nonzero_cost * nonzeros, tokens


def intrinsic_gas(tx, fork) -> tuple[int, int]:
    """Returns (intrinsic, floor) gas for the fork's schedule; floor only
    binds in Prague+ (EIP-7623)."""
    from ..primitives.genesis import Fork

    sched = schedule_for(fork)
    data_cost, tokens = tx_data_cost(tx.data, sched.tx_nonzero)
    gas = TX_BASE + data_cost
    if tx.is_create:
        gas += sched.tx_create
        if fork >= Fork.SHANGHAI:
            gas += init_code_cost(len(tx.data))
    for _, slots in tx.access_list:
        gas += TX_ACCESS_LIST_ADDR + TX_ACCESS_LIST_SLOT * len(slots)
    gas += PER_EMPTY_ACCOUNT_AUTH * len(tx.authorization_list)
    floor = TX_BASE + TX_FLOOR_TOKEN_COST * tokens \
        if fork >= Fork.PRAGUE else 0
    return gas, floor


def fake_exponential(factor: int, numerator: int, denominator: int) -> int:
    """EIP-4844 blob base fee exponential approximation."""
    i = 1
    output = 0
    acc = factor * denominator
    while acc > 0:
        output += acc
        acc = acc * numerator // (denominator * i)
        i += 1
    return output // denominator


def blob_base_fee(excess_blob_gas: int,
                  fraction: int = BLOB_BASE_FEE_UPDATE_FRACTION) -> int:
    return fake_exponential(MIN_BLOB_BASE_FEE, excess_blob_gas, fraction)


BLOB_BASE_COST = 1 << 13  # EIP-7918


def calc_excess_blob_gas(parent_excess: int, parent_used: int,
                         target: int = TARGET_BLOB_GAS_PER_BLOCK,
                         max_blob_gas: int | None = None,
                         fraction: int = BLOB_BASE_FEE_UPDATE_FRACTION,
                         parent_base_fee: int | None = None,
                         eip7918: bool = False) -> int:
    """EIP-4844 excess update, with the EIP-7918 reserve-price branch
    from Osaka: when execution gas is the better deal
    (BLOB_BASE_COST * base_fee > GAS_PER_BLOB * blob_base_fee), excess
    decays proportionally instead of by the full target."""
    total = parent_excess + parent_used
    if total < target:
        return 0
    if eip7918 and parent_base_fee is not None and max_blob_gas:
        if BLOB_BASE_COST * parent_base_fee > \
                BLOB_GAS_PER_BLOB * blob_base_fee(parent_excess, fraction):
            return parent_excess + parent_used * (max_blob_gas - target) \
                // max_blob_gas
    return total - target
