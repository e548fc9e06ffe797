// Native EVM hot loop: straight-line opcode dispatch / stack / gas in C++.
//
// The seat of the reference's interpreter performance work (the LEVM
// dispatch loop, crates/vm/levm/src/vm.rs hot path).  Scope: every opcode
// whose semantics are FRAME-LOCAL — arithmetic, bitwise, comparisons,
// KECCAK256 (via the in-repo keccak.c), memory, jumps, PUSH/DUP/SWAP/POP,
// calldata/code reads, RETURN/REVERT — runs here at C speed with exact
// gas accounting.  Anything touching the StateDB, environment or
// sub-calls ESCAPES back to the Python interpreter, which executes that
// single opcode with the canonical handlers and re-enters the loop
// (ethrex_tpu_torch/evm/native_vm.py).  Gas constants mirror evm/gas.py and are
// differential-tested over the whole EF fixture ladder.
//
// u256 = 4 x uint64 little-endian limbs, fixed 1024-deep stack owned by
// the frame.  Memory and stack currently round-trip in FULL on every
// escape (pull_into/push_from in native_vm.py) — fine for the measured
// workloads (escapes are rare in hot code), but escape-dense contracts
// with large memory pay O(escapes x mem_size); dirty-range or
// operand-only sync is the known next optimization.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <vector>

extern "C" void keccak256(const unsigned char *data, size_t len,
                          unsigned char *out);

namespace {

struct u256 {
    uint64_t w[4];  // little-endian limbs
};

static inline u256 zero256() { return u256{{0, 0, 0, 0}}; }

static inline bool is_zero(const u256 &a) {
    return (a.w[0] | a.w[1] | a.w[2] | a.w[3]) == 0;
}

static inline int cmp(const u256 &a, const u256 &b) {
    for (int i = 3; i >= 0; --i) {
        if (a.w[i] < b.w[i]) return -1;
        if (a.w[i] > b.w[i]) return 1;
    }
    return 0;
}

static inline u256 add256(const u256 &a, const u256 &b) {
    u256 r;
    unsigned __int128 c = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 s = (unsigned __int128)a.w[i] + b.w[i] + c;
        r.w[i] = (uint64_t)s;
        c = s >> 64;
    }
    return r;
}

static inline u256 sub256(const u256 &a, const u256 &b) {
    u256 r;
    unsigned __int128 borrow = 0;
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 d = (unsigned __int128)a.w[i] - b.w[i] - borrow;
        r.w[i] = (uint64_t)d;
        borrow = (d >> 64) & 1;
    }
    return r;
}

static inline u256 mul256(const u256 &a, const u256 &b) {
    uint64_t res[8] = {0};
    for (int i = 0; i < 4; ++i) {
        unsigned __int128 carry = 0;
        for (int j = 0; i + j < 4; ++j) {
            unsigned __int128 cur = (unsigned __int128)a.w[i] * b.w[j]
                + res[i + j] + carry;
            res[i + j] = (uint64_t)cur;
            carry = cur >> 64;
        }
    }
    u256 r;
    memcpy(r.w, res, 32);
    return r;
}

static inline int bits256(const u256 &a) {
    for (int i = 3; i >= 0; --i)
        if (a.w[i]) return 64 * i + (64 - __builtin_clzll(a.w[i]));
    return 0;
}

static inline u256 shl256(const u256 &a, unsigned sh) {
    u256 r = zero256();
    if (sh >= 256) return r;
    unsigned limb = sh / 64, off = sh % 64;
    for (int i = 3; i >= 0; --i) {
        uint64_t v = 0;
        int src = i - (int)limb;
        if (src >= 0) {
            v = a.w[src] << off;
            if (off && src - 1 >= 0) v |= a.w[src - 1] >> (64 - off);
        }
        r.w[i] = v;
    }
    return r;
}

static inline u256 shr256(const u256 &a, unsigned sh) {
    u256 r = zero256();
    if (sh >= 256) return r;
    unsigned limb = sh / 64, off = sh % 64;
    for (int i = 0; i < 4; ++i) {
        uint64_t v = 0;
        unsigned src = i + limb;
        if (src < 4) {
            v = a.w[src] >> off;
            if (off && src + 1 < 4) v |= a.w[src + 1] << (64 - off);
        }
        r.w[i] = v;
    }
    return r;
}

// Knuth-free long division via base-2^32 schoolbook (q, r) = a / b.
static void divmod256(const u256 &a, const u256 &b, u256 &q, u256 &r) {
    q = zero256();
    r = zero256();
    if (is_zero(b)) return;
    if (cmp(a, b) < 0) { r = a; return; }
    int shift = bits256(a) - bits256(b);
    u256 d = shl256(b, shift);
    u256 rem = a;
    for (int i = shift; i >= 0; --i) {
        if (cmp(rem, d) >= 0) {
            rem = sub256(rem, d);
            q.w[i / 64] |= (uint64_t)1 << (i % 64);
        }
        d = shr256(d, 1);
    }
    r = rem;
}

static inline bool neg256(const u256 &a) { return a.w[3] >> 63; }

static inline u256 negate256(const u256 &a) {
    return sub256(zero256(), a);
}

static inline u256 from_u64(uint64_t v) { return u256{{v, 0, 0, 0}}; }

static inline uint64_t low_u64_capped(const u256 &a) {
    // value clamped to "huge" when it exceeds 64 bits (for offsets)
    if (a.w[1] | a.w[2] | a.w[3]) return UINT64_MAX;
    return a.w[0];
}

// big-endian <-> u256
static inline void u256_to_be(const u256 &a, uint8_t out[32]) {
    for (int i = 0; i < 4; ++i) {
        uint64_t w = a.w[3 - i];
        for (int j = 0; j < 8; ++j)
            out[i * 8 + j] = (uint8_t)(w >> (56 - 8 * j));
    }
}

static inline u256 be_to_u256(const uint8_t *p, size_t len) {
    uint8_t buf[32] = {0};
    memcpy(buf + (32 - len), p, len);
    u256 r;
    for (int i = 0; i < 4; ++i) {
        uint64_t w = 0;
        for (int j = 0; j < 8; ++j) w = (w << 8) | buf[i * 8 + j];
        r.w[3 - i] = w;
    }
    return r;
}

// ---- gas constants (mirror ethrex_tpu_torch/evm/gas.py) ------------------
enum {
    G_BASE = 2, G_VERYLOW = 3, G_LOW = 5, G_MID = 8, G_HIGH = 10,
    G_JUMPDEST = 1, G_KECCAK = 30, G_KECCAK_WORD = 6, G_COPY_WORD = 3,
    G_EXP = 10,
};

enum HaltReason {
    HALT_STOP = 0, HALT_RETURN = 1, HALT_REVERT = 2, HALT_ESCAPE = 3,
    HALT_OOG = 4, HALT_INVALID_OP = 5, HALT_INVALID_JUMP = 6,
    HALT_STACK = 7, HALT_CODE_END = 8,
};

struct Frame {
    std::vector<uint8_t> code;
    std::vector<uint8_t> calldata;
    std::vector<uint8_t> memory;      // 32-byte aligned size
    std::vector<uint8_t> jumpdests;   // bitmap
    u256 stack[1024];
    uint32_t sp = 0;
    uint64_t gas = 0;
    uint64_t pc = 0;
    uint64_t exp_byte = 50;           // fork-dependent EXP byte cost
    // opcode handled-natively bitmap (fork-gated from Python: an opcode
    // absent at the frame's fork is NOT in the map, so it escapes and
    // Python raises its InvalidOpcode with the right semantics)
    uint8_t native_ok[256];
    uint64_t ret_off = 0, ret_len = 0;  // RETURN/REVERT output window
};

static inline uint64_t mem_cost(uint64_t size_bytes) {
    uint64_t w = (size_bytes + 31) / 32;
    return 3 * w + (w * w) / 512;
}

static bool charge(Frame *f, uint64_t amount) {
    if (f->gas < amount) return false;
    f->gas -= amount;
    return true;
}

// returns false on OOG; expands memory (size tracked via vector size)
static bool expand_memory(Frame *f, uint64_t offset, uint64_t length) {
    if (length == 0) return true;
    uint64_t new_size = offset + length;
    if (new_size > f->memory.size()) {
        uint64_t cost = mem_cost(new_size) - mem_cost(f->memory.size());
        if (!charge(f, cost)) return false;
        uint64_t aligned = ((new_size + 31) / 32) * 32;
        f->memory.resize(aligned, 0);
    }
    return true;
}

static const uint64_t MEM_BOUND = (uint64_t)1 << 32;

} // namespace

extern "C" {

void *evm_frame_new(const uint8_t *code, size_t code_len,
                    const uint8_t *calldata, size_t calldata_len,
                    uint64_t gas, uint64_t exp_byte,
                    const uint8_t *native_ok) {
    Frame *f = new Frame();
    f->code.assign(code, code + code_len);
    f->calldata.assign(calldata, calldata + calldata_len);
    f->gas = gas;
    f->exp_byte = exp_byte;
    memcpy(f->native_ok, native_ok, 256);
    // jumpdest analysis (identical rule to vm._valid_jumpdests)
    f->jumpdests.assign((code_len + 7) / 8, 0);
    for (size_t i = 0; i < code_len;) {
        uint8_t op = code[i];
        if (op == 0x5B) {
            f->jumpdests[i / 8] |= 1 << (i % 8);
            i += 1;
        } else if (op >= 0x60 && op <= 0x7F) {
            i += (size_t)(op - 0x5F) + 1;
        } else {
            i += 1;
        }
    }
    return f;
}

void evm_frame_free(void *p) { delete (Frame *)p; }

uint64_t evm_gas(void *p) { return ((Frame *)p)->gas; }
void evm_set_gas(void *p, uint64_t g) { ((Frame *)p)->gas = g; }
uint64_t evm_pc(void *p) { return ((Frame *)p)->pc; }
void evm_set_pc(void *p, uint64_t pc) { ((Frame *)p)->pc = pc; }
uint32_t evm_stack_len(void *p) { return ((Frame *)p)->sp; }

// stack I/O as big-endian 32-byte words (index 0 = bottom)
void evm_stack_read(void *p, uint8_t *out) {
    Frame *f = (Frame *)p;
    for (uint32_t i = 0; i < f->sp; ++i)
        u256_to_be(f->stack[i], out + 32 * i);
}

void evm_stack_write(void *p, const uint8_t *in, uint32_t n) {
    Frame *f = (Frame *)p;
    f->sp = n;
    for (uint32_t i = 0; i < n; ++i)
        f->stack[i] = be_to_u256(in + 32 * i, 32);
}

uint64_t evm_mem_size(void *p) { return ((Frame *)p)->memory.size(); }

void evm_mem_read(void *p, uint8_t *out) {
    Frame *f = (Frame *)p;
    if (!f->memory.empty())
        memcpy(out, f->memory.data(), f->memory.size());
}

void evm_mem_write(void *p, const uint8_t *in, uint64_t n) {
    Frame *f = (Frame *)p;
    f->memory.assign(in, in + n);
}

uint64_t evm_ret_off(void *p) { return ((Frame *)p)->ret_off; }
uint64_t evm_ret_len(void *p) { return ((Frame *)p)->ret_len; }

// Run until halt or escape.  Returns a HaltReason; on HALT_ESCAPE the pc
// points AT the escaping opcode and all state is current.
int evm_run(void *p) {
    Frame *f = (Frame *)p;
    const uint8_t *code = f->code.data();
    const uint64_t n = f->code.size();

#define NEED(k) do { if (f->sp < (k)) return HALT_STACK; } while (0)
#define ROOM() do { if (f->sp >= 1024) return HALT_STACK; } while (0)
#define GAS(g) do { if (!charge(f, (g))) return HALT_OOG; } while (0)
#define BOUND(off, len) \
    do { if ((off) > MEM_BOUND || (len) > MEM_BOUND) return HALT_OOG; } \
    while (0)

    while (f->pc < n) {
        uint8_t op = code[f->pc];
        if (!f->native_ok[op]) return HALT_ESCAPE;
        f->pc++;
        switch (op) {
        case 0x00: return HALT_STOP;
        case 0x01: { // ADD
            GAS(G_VERYLOW); NEED(2);
            f->stack[f->sp - 2] = add256(f->stack[f->sp - 1],
                                         f->stack[f->sp - 2]);
            f->sp--; break;
        }
        case 0x02: { // MUL
            GAS(G_LOW); NEED(2);
            f->stack[f->sp - 2] = mul256(f->stack[f->sp - 1],
                                         f->stack[f->sp - 2]);
            f->sp--; break;
        }
        case 0x03: { // SUB
            GAS(G_VERYLOW); NEED(2);
            f->stack[f->sp - 2] = sub256(f->stack[f->sp - 1],
                                         f->stack[f->sp - 2]);
            f->sp--; break;
        }
        case 0x04: { // DIV
            GAS(G_LOW); NEED(2);
            u256 q, r;
            divmod256(f->stack[f->sp - 1], f->stack[f->sp - 2], q, r);
            f->stack[f->sp - 2] = q;
            f->sp--; break;
        }
        case 0x05: { // SDIV
            GAS(G_LOW); NEED(2);
            u256 a = f->stack[f->sp - 1], b = f->stack[f->sp - 2];
            u256 q, r;
            if (is_zero(b)) { q = zero256(); }
            else {
                u256 ua = neg256(a) ? negate256(a) : a;
                u256 ub = neg256(b) ? negate256(b) : b;
                divmod256(ua, ub, q, r);
                if (neg256(a) != neg256(b)) q = negate256(q);
            }
            f->stack[f->sp - 2] = q;
            f->sp--; break;
        }
        case 0x06: { // MOD
            GAS(G_LOW); NEED(2);
            u256 q, r;
            divmod256(f->stack[f->sp - 1], f->stack[f->sp - 2], q, r);
            f->stack[f->sp - 2] = r;
            f->sp--; break;
        }
        case 0x07: { // SMOD
            GAS(G_LOW); NEED(2);
            u256 a = f->stack[f->sp - 1], b = f->stack[f->sp - 2];
            u256 q, r;
            if (is_zero(b)) { r = zero256(); }
            else {
                u256 ua = neg256(a) ? negate256(a) : a;
                u256 ub = neg256(b) ? negate256(b) : b;
                divmod256(ua, ub, q, r);
                if (neg256(a) && !is_zero(r)) r = negate256(r);
            }
            f->stack[f->sp - 2] = r;
            f->sp--; break;
        }
        case 0x08: case 0x09: { // ADDMOD / MULMOD: escape (needs >256-bit)
            // MULMOD needs 512-bit intermediates; ADDMOD kept with it for
            // simplicity — both are rare in hot code
            f->pc--;
            return HALT_ESCAPE;
        }
        case 0x0A: { // EXP
            NEED(2);
            u256 base = f->stack[f->sp - 1], ex = f->stack[f->sp - 2];
            uint64_t blen = (bits256(ex) + 7) / 8;
            GAS(G_EXP + f->exp_byte * blen);
            u256 result = from_u64(1);
            u256 acc = base;
            int nb = bits256(ex);
            for (int i = 0; i < nb; ++i) {
                if ((ex.w[i / 64] >> (i % 64)) & 1)
                    result = mul256(result, acc);
                acc = mul256(acc, acc);
            }
            f->stack[f->sp - 2] = result;
            f->sp--; break;
        }
        case 0x0B: { // SIGNEXTEND
            GAS(G_LOW); NEED(2);
            u256 k = f->stack[f->sp - 1], v = f->stack[f->sp - 2];
            u256 out = v;
            uint64_t kk = low_u64_capped(k);
            if (kk < 31) {
                unsigned bit = 8 * (unsigned)(kk + 1) - 1;
                bool set = (v.w[bit / 64] >> (bit % 64)) & 1;
                for (unsigned i = bit + 1; i < 256; ++i) {
                    if (set) out.w[i / 64] |= (uint64_t)1 << (i % 64);
                    else out.w[i / 64] &= ~((uint64_t)1 << (i % 64));
                }
            }
            f->stack[f->sp - 2] = out;
            f->sp--; break;
        }
        case 0x10: case 0x11: { // LT / GT
            GAS(G_VERYLOW); NEED(2);
            int c = cmp(f->stack[f->sp - 1], f->stack[f->sp - 2]);
            bool res = (op == 0x10) ? (c < 0) : (c > 0);
            f->stack[f->sp - 2] = from_u64(res);
            f->sp--; break;
        }
        case 0x12: case 0x13: { // SLT / SGT
            GAS(G_VERYLOW); NEED(2);
            u256 a = f->stack[f->sp - 1], b = f->stack[f->sp - 2];
            bool na = neg256(a), nb = neg256(b);
            int c = (na != nb) ? (na ? -1 : 1) : cmp(a, b);
            bool res = (op == 0x12) ? (c < 0) : (c > 0);
            f->stack[f->sp - 2] = from_u64(res);
            f->sp--; break;
        }
        case 0x14: { // EQ
            GAS(G_VERYLOW); NEED(2);
            f->stack[f->sp - 2] =
                from_u64(cmp(f->stack[f->sp - 1], f->stack[f->sp - 2]) == 0);
            f->sp--; break;
        }
        case 0x15: { // ISZERO
            GAS(G_VERYLOW); NEED(1);
            f->stack[f->sp - 1] = from_u64(is_zero(f->stack[f->sp - 1]));
            break;
        }
        case 0x16: case 0x17: case 0x18: { // AND / OR / XOR
            GAS(G_VERYLOW); NEED(2);
            u256 a = f->stack[f->sp - 1], b = f->stack[f->sp - 2], r;
            for (int i = 0; i < 4; ++i)
                r.w[i] = op == 0x16 ? (a.w[i] & b.w[i])
                       : op == 0x17 ? (a.w[i] | b.w[i])
                                    : (a.w[i] ^ b.w[i]);
            f->stack[f->sp - 2] = r;
            f->sp--; break;
        }
        case 0x19: { // NOT
            GAS(G_VERYLOW); NEED(1);
            for (int i = 0; i < 4; ++i)
                f->stack[f->sp - 1].w[i] = ~f->stack[f->sp - 1].w[i];
            break;
        }
        case 0x1A: { // BYTE
            GAS(G_VERYLOW); NEED(2);
            u256 idx = f->stack[f->sp - 1], v = f->stack[f->sp - 2];
            uint64_t i = low_u64_capped(idx);
            uint8_t be[32];
            u256_to_be(v, be);
            f->stack[f->sp - 2] = from_u64(i < 32 ? be[i] : 0);
            f->sp--; break;
        }
        case 0x1B: { // SHL
            GAS(G_VERYLOW); NEED(2);
            uint64_t sh = low_u64_capped(f->stack[f->sp - 1]);
            f->stack[f->sp - 2] = sh >= 256 ? zero256()
                : shl256(f->stack[f->sp - 2], (unsigned)sh);
            f->sp--; break;
        }
        case 0x1C: { // SHR
            GAS(G_VERYLOW); NEED(2);
            uint64_t sh = low_u64_capped(f->stack[f->sp - 1]);
            f->stack[f->sp - 2] = sh >= 256 ? zero256()
                : shr256(f->stack[f->sp - 2], (unsigned)sh);
            f->sp--; break;
        }
        case 0x1D: { // SAR
            GAS(G_VERYLOW); NEED(2);
            uint64_t sh = low_u64_capped(f->stack[f->sp - 1]);
            u256 v = f->stack[f->sp - 2];
            u256 r;
            if (sh >= 256) {
                r = neg256(v) ? sub256(zero256(), from_u64(1)) : zero256();
            } else {
                r = shr256(v, (unsigned)sh);
                if (neg256(v) && sh) {
                    // fill the vacated high bits with ones
                    u256 ones = sub256(zero256(), from_u64(1));
                    u256 mask = shl256(ones, 256 - (unsigned)sh);
                    for (int i = 0; i < 4; ++i) r.w[i] |= mask.w[i];
                }
            }
            f->stack[f->sp - 2] = r;
            f->sp--; break;
        }
        case 0x20: { // KECCAK256
            NEED(2);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            uint64_t len = low_u64_capped(f->stack[f->sp - 2]);
            BOUND(off, len);
            GAS(G_KECCAK + G_KECCAK_WORD * ((len + 31) / 32));
            if (!expand_memory(f, off, len)) return HALT_OOG;
            uint8_t out[32];
            keccak256(len ? f->memory.data() + off : out, len, out);
            f->sp -= 2;
            f->stack[f->sp++] = be_to_u256(out, 32);
            break;
        }
        case 0x35: { // CALLDATALOAD
            GAS(G_VERYLOW); NEED(1);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            uint8_t buf[32] = {0};
            if (off < f->calldata.size()) {
                size_t avail = f->calldata.size() - off;
                memcpy(buf, f->calldata.data() + off,
                       avail < 32 ? avail : 32);
            }
            f->stack[f->sp - 1] = be_to_u256(buf, 32);
            break;
        }
        case 0x36: { // CALLDATASIZE
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = from_u64(f->calldata.size());
            break;
        }
        case 0x37: case 0x39: { // CALLDATACOPY / CODECOPY
            NEED(3);
            uint64_t dst = low_u64_capped(f->stack[f->sp - 1]);
            uint64_t src = low_u64_capped(f->stack[f->sp - 2]);
            uint64_t len = low_u64_capped(f->stack[f->sp - 3]);
            f->sp -= 3;
            BOUND(dst, len);
            GAS(G_VERYLOW + G_COPY_WORD * ((len + 31) / 32));
            if (!expand_memory(f, dst, len)) return HALT_OOG;
            if (len) {
                const std::vector<uint8_t> &srcbuf =
                    op == 0x37 ? f->calldata : f->code;
                uint64_t avail = src < srcbuf.size()
                    ? srcbuf.size() - src : 0;
                uint64_t ncopy = avail < len ? avail : len;
                if (ncopy)
                    memcpy(f->memory.data() + dst, srcbuf.data() + src,
                           ncopy);
                if (ncopy < len)
                    memset(f->memory.data() + dst + ncopy, 0, len - ncopy);
            }
            break;
        }
        case 0x38: { // CODESIZE
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = from_u64(f->code.size());
            break;
        }
        case 0x50: { // POP
            GAS(G_BASE); NEED(1);
            f->sp--; break;
        }
        case 0x51: { // MLOAD
            NEED(1);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            BOUND(off, 32);
            GAS(G_VERYLOW);
            if (!expand_memory(f, off, 32)) return HALT_OOG;
            f->stack[f->sp - 1] = be_to_u256(f->memory.data() + off, 32);
            break;
        }
        case 0x52: { // MSTORE
            NEED(2);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            BOUND(off, 32);
            GAS(G_VERYLOW);
            if (!expand_memory(f, off, 32)) return HALT_OOG;
            u256_to_be(f->stack[f->sp - 2], f->memory.data() + off);
            f->sp -= 2;
            break;
        }
        case 0x53: { // MSTORE8
            NEED(2);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            BOUND(off, 1);
            GAS(G_VERYLOW);
            if (!expand_memory(f, off, 1)) return HALT_OOG;
            f->memory[off] = (uint8_t)(f->stack[f->sp - 2].w[0] & 0xFF);
            f->sp -= 2;
            break;
        }
        case 0x56: { // JUMP
            GAS(G_MID); NEED(1);
            uint64_t dest = low_u64_capped(f->stack[f->sp - 1]);
            f->sp--;
            if (dest >= n ||
                !(f->jumpdests[dest / 8] & (1 << (dest % 8))))
                return HALT_INVALID_JUMP;
            f->pc = dest;
            break;
        }
        case 0x57: { // JUMPI
            GAS(G_HIGH); NEED(2);
            uint64_t dest = low_u64_capped(f->stack[f->sp - 1]);
            bool cond = !is_zero(f->stack[f->sp - 2]);
            f->sp -= 2;
            if (cond) {
                if (dest >= n ||
                    !(f->jumpdests[dest / 8] & (1 << (dest % 8))))
                    return HALT_INVALID_JUMP;
                f->pc = dest;
            }
            break;
        }
        case 0x58: { // PC
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = from_u64(f->pc - 1);
            break;
        }
        case 0x59: { // MSIZE
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = from_u64(f->memory.size());
            break;
        }
        case 0x5A: { // GAS
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = from_u64(f->gas);
            break;
        }
        case 0x5B: { // JUMPDEST
            GAS(G_JUMPDEST);
            break;
        }
        case 0x5E: { // MCOPY (in the map only when the fork has it)
            NEED(3);
            uint64_t dst = low_u64_capped(f->stack[f->sp - 1]);
            uint64_t src = low_u64_capped(f->stack[f->sp - 2]);
            uint64_t len = low_u64_capped(f->stack[f->sp - 3]);
            f->sp -= 3;
            uint64_t mx = dst > src ? dst : src;
            BOUND(mx, len);
            GAS(G_VERYLOW + G_COPY_WORD * ((len + 31) / 32));
            if (len) {
                if (!expand_memory(f, mx, len)) return HALT_OOG;
                memmove(f->memory.data() + dst, f->memory.data() + src,
                        len);
            }
            break;
        }
        case 0x5F: { // PUSH0
            GAS(G_BASE); ROOM();
            f->stack[f->sp++] = zero256();
            break;
        }
        case 0xF3: case 0xFD: { // RETURN / REVERT
            NEED(2);
            uint64_t off = low_u64_capped(f->stack[f->sp - 1]);
            uint64_t len = low_u64_capped(f->stack[f->sp - 2]);
            f->sp -= 2;
            BOUND(off, len);
            if (!expand_memory(f, off, len)) return HALT_OOG;
            f->ret_off = off;
            f->ret_len = len;
            return op == 0xF3 ? HALT_RETURN : HALT_REVERT;
        }
        case 0xFE:
            return HALT_INVALID_OP;
        default: {
            if (op >= 0x60 && op <= 0x7F) {       // PUSH1..32
                GAS(G_VERYLOW); ROOM();
                size_t nbytes = op - 0x5F;
                size_t avail = f->pc < n ? n - f->pc : 0;
                size_t take = avail < nbytes ? avail : nbytes;
                uint8_t buf[32] = {0};
                // right-pad with zeros like the Python handler
                memcpy(buf, code + f->pc, take);
                memset(buf + take, 0, nbytes - take);
                f->stack[f->sp++] = be_to_u256(buf, nbytes);
                f->pc += nbytes;
                break;
            }
            if (op >= 0x80 && op <= 0x8F) {       // DUP1..16
                GAS(G_VERYLOW);
                uint32_t depth = op - 0x7F;
                NEED(depth); ROOM();
                f->stack[f->sp] = f->stack[f->sp - depth];
                f->sp++;
                break;
            }
            if (op >= 0x90 && op <= 0x9F) {       // SWAP1..16
                GAS(G_VERYLOW);
                uint32_t depth = op - 0x8F;
                NEED(depth + 1);
                u256 tmp = f->stack[f->sp - 1];
                f->stack[f->sp - 1] = f->stack[f->sp - 1 - depth];
                f->stack[f->sp - 1 - depth] = tmp;
                break;
            }
            // anything else that was marked native is a bug; escape
            f->pc--;
            return HALT_ESCAPE;
        }
        }
    }
    return HALT_CODE_END;
}

} // extern "C"
