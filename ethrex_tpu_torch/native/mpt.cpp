// Native Merkle-Patricia-Trie engine: the merkleize hot path of block
// import (parity seat: the reference's ethrex-trie + its trie-optimization
// rounds, crates/common/trie; behavioral parity with this
// repo's ethrex_tpu_torch/trie/trie.py, which remains the reference
// implementation and the differential-test oracle).
//
// Design:
//   * The engine OWNS a node map (keccak(rlp) -> rlp bytes) that persists
//     across batch applies, so Python feeds each node at most once.
//   * One C call applies a whole ordered batch of (key, value|delete) ops
//     against a root and commits: new nodes land in the map AND in a
//     "fresh" list Python drains to persist into its own store.
//   * Missing nodes (pruned tables) abort the apply before any mutation
//     and report the full frontier of missing hashes, so the caller feeds
//     them and retries — a few round trips per batch, not per node.
//
// Build: g++ -O3 -shared -fPIC -o libmpt.so mpt.cpp keccak.c
// (keccak.c provides keccak256; see keccak.c beside this file)

#include <cstdint>
#include <cstring>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

extern "C" void keccak256(const uint8_t *in, size_t len, uint8_t *out);

namespace {

using bytes = std::string;

struct HashKey {
    std::size_t operator()(const bytes &b) const {
        uint64_t v;
        std::memcpy(&v, b.data(), 8);
        return static_cast<std::size_t>(v);
    }
};

bytes keccak(const bytes &data) {
    bytes out(32, '\0');
    keccak256(reinterpret_cast<const uint8_t *>(data.data()), data.size(),
              reinterpret_cast<uint8_t *>(&out[0]));
    return out;
}

// ---------------------------------------------------------------------------
// Minimal RLP
// ---------------------------------------------------------------------------

struct RlpItem {
    bool is_list = false;
    bytes str;                  // string payload
    bytes raw;                  // full encoding (lists keep raw for reuse)
    std::vector<RlpItem> items; // list members
};

struct RlpError {};

size_t rlp_parse(const uint8_t *d, size_t len, size_t pos, RlpItem &out);

size_t rlp_parse_payload(const uint8_t *d, size_t pos, size_t plen,
                         size_t hdr, bool is_list, RlpItem &out) {
    out.is_list = is_list;
    out.raw.assign(reinterpret_cast<const char *>(d + pos), hdr + plen);
    if (!is_list) {
        out.str.assign(reinterpret_cast<const char *>(d + pos + hdr), plen);
    } else {
        size_t p = pos + hdr, end = pos + hdr + plen;
        while (p < end) {
            RlpItem sub;
            p = rlp_parse(d, end, p, sub);
            out.items.push_back(std::move(sub));
        }
        if (p != end) throw RlpError{};
    }
    return pos + hdr + plen;
}

size_t rlp_parse(const uint8_t *d, size_t len, size_t pos, RlpItem &out) {
    if (pos >= len) throw RlpError{};
    uint8_t b = d[pos];
    if (b < 0x80) {
        out.is_list = false;
        out.str.assign(1, static_cast<char>(b));
        out.raw = out.str;
        return pos + 1;
    }
    auto need = [&](size_t n) { if (pos + n > len) throw RlpError{}; };
    if (b <= 0xB7) {
        size_t plen = b - 0x80;
        need(1 + plen);
        return rlp_parse_payload(d, pos, plen, 1, false, out);
    }
    if (b <= 0xBF) {
        size_t ll = b - 0xB7;
        need(1 + ll);
        size_t plen = 0;
        for (size_t i = 0; i < ll; i++) plen = (plen << 8) | d[pos + 1 + i];
        need(1 + ll + plen);
        return rlp_parse_payload(d, pos, plen, 1 + ll, false, out);
    }
    if (b <= 0xF7) {
        size_t plen = b - 0xC0;
        need(1 + plen);
        return rlp_parse_payload(d, pos, plen, 1, true, out);
    }
    size_t ll = b - 0xF7;
    need(1 + ll);
    size_t plen = 0;
    for (size_t i = 0; i < ll; i++) plen = (plen << 8) | d[pos + 1 + i];
    need(1 + ll + plen);
    return rlp_parse_payload(d, pos, plen, 1 + ll, true, out);
}

bytes rlp_len_prefix(size_t n, uint8_t base_short, uint8_t base_long) {
    bytes out;
    if (n <= 55) {
        out.push_back(static_cast<char>(base_short + n));
        return out;
    }
    bytes be;
    while (n) { be.insert(be.begin(), static_cast<char>(n & 0xFF)); n >>= 8; }
    out.push_back(static_cast<char>(base_long + be.size()));
    out += be;
    return out;
}

bytes rlp_encode_string(const bytes &s) {
    if (s.size() == 1 && static_cast<uint8_t>(s[0]) < 0x80) return s;
    return rlp_len_prefix(s.size(), 0x80, 0xB7) + s;
}

bytes rlp_encode_list_payload(const bytes &payload) {
    return rlp_len_prefix(payload.size(), 0xC0, 0xF7) + payload;
}

// ---------------------------------------------------------------------------
// Trie nodes
// ---------------------------------------------------------------------------

enum Kind : uint8_t { LEAF, EXT, BRANCH, REF_HASH, REF_INLINE };

struct Node {
    Kind kind;
    bytes path;   // nibbles (one per byte), leaf/ext
    bytes value;  // leaf value / branch value
    Node *children[16] = {nullptr};
    Node *child = nullptr; // ext
    bytes ref;    // 32-byte hash (REF_HASH) or raw rlp slice (REF_INLINE)
};

struct MissingError { bytes hash; };

// host resolver: returns 1 when it fed the node (via mpt_load), 0 if the
// node does not exist anywhere — one upcall per unique node, no restarts
typedef int (*resolver_fn)(const uint8_t *hash32);

struct Engine {
    std::unordered_map<bytes, bytes, HashKey> nodes;
    std::vector<bytes> fresh;        // rlp of nodes created by last commit
    std::unordered_set<bytes, HashKey> missing;
    std::vector<std::unique_ptr<Node>> arena;
    resolver_fn resolver = nullptr;

    Node *alloc() {
        arena.emplace_back(new Node());
        return arena.back().get();
    }

    Node *make_ref_hash(const bytes &h) {
        Node *n = alloc();
        n->kind = REF_HASH;
        n->ref = h;
        return n;
    }

    // hex-prefix decode into nibbles + leaf flag
    static void hp_decode(const bytes &data, bytes &nibbles, bool &leaf) {
        if (data.empty()) throw RlpError{};
        uint8_t flag = static_cast<uint8_t>(data[0]) >> 4;
        leaf = (flag & 2) != 0;
        nibbles.clear();
        if (flag & 1) nibbles.push_back(data[0] & 0xF);
        for (size_t i = 1; i < data.size(); i++) {
            nibbles.push_back((static_cast<uint8_t>(data[i]) >> 4));
            nibbles.push_back(data[i] & 0xF);
        }
    }

    static bytes hp_encode(const bytes &nib, bool leaf) {
        uint8_t flag = leaf ? 2 : 0;
        bytes out;
        size_t i = 0;
        if (nib.size() % 2) {
            out.push_back(static_cast<char>(((flag + 1) << 4) | nib[0]));
            i = 1;
        } else {
            out.push_back(static_cast<char>(flag << 4));
        }
        for (; i + 1 < nib.size(); i += 2)
            out.push_back(static_cast<char>((nib[i] << 4) | nib[i + 1]));
        return out;
    }

    Node *decode(const RlpItem &item) {
        if (!item.is_list) {
            if (item.str.empty()) return nullptr;
            Node *n = alloc();
            n->kind = REF_HASH;
            n->ref = item.str;
            return n;
        }
        if (item.items.size() == 17) {
            Node *n = alloc();
            n->kind = BRANCH;
            for (int i = 0; i < 16; i++) {
                const RlpItem &c = item.items[i];
                if (c.is_list) {
                    Node *r = alloc();
                    r->kind = REF_INLINE;
                    r->ref = c.raw;
                    n->children[i] = r;
                } else if (c.str.empty()) {
                    n->children[i] = nullptr;
                } else {
                    n->children[i] = make_ref_hash(c.str);
                }
            }
            n->value = item.items[16].str;
            return n;
        }
        if (item.items.size() == 2) {
            bytes nib;
            bool leaf;
            hp_decode(item.items[0].str, nib, leaf);
            Node *n = alloc();
            n->path = nib;
            if (leaf) {
                n->kind = LEAF;
                n->value = item.items[1].str;
            } else {
                n->kind = EXT;
                const RlpItem &c = item.items[1];
                if (c.is_list) {
                    Node *r = alloc();
                    r->kind = REF_INLINE;
                    r->ref = c.raw;
                    n->child = r;
                } else {
                    n->child = make_ref_hash(c.str);
                }
            }
            return n;
        }
        throw RlpError{};
    }

    Node *decode_bytes(const bytes &raw) {
        RlpItem item;
        rlp_parse(reinterpret_cast<const uint8_t *>(raw.data()), raw.size(),
                  0, item);
        return decode(item);
    }

    Node *resolve(Node *n) {
        while (n && (n->kind == REF_HASH || n->kind == REF_INLINE)) {
            if (n->kind == REF_INLINE) {
                n = decode_bytes(n->ref);
                continue;
            }
            auto it = nodes.find(n->ref);
            if (it == nodes.end()) {
                if (resolver &&
                    resolver(reinterpret_cast<const uint8_t *>(
                        n->ref.data()))) {
                    it = nodes.find(n->ref);
                    if (it != nodes.end()) {
                        n = decode_bytes(it->second);
                        continue;
                    }
                }
                throw MissingError{n->ref};
            }
            n = decode_bytes(it->second);
        }
        return n;
    }

    // ---- mutation (mirrors trie/trie.py exactly) ----------------------

    static size_t common_prefix(const bytes &a, const bytes &b) {
        size_t i = 0;
        while (i < a.size() && i < b.size() && a[i] == b[i]) i++;
        return i;
    }

    Node *make_leaf(const bytes &path, const bytes &value) {
        Node *n = alloc();
        n->kind = LEAF;
        n->path = path;
        n->value = value;
        return n;
    }

    Node *make_ext(const bytes &path, Node *child) {
        Node *n = alloc();
        n->kind = EXT;
        n->path = path;
        n->child = child;
        return n;
    }

    Node *split(const bytes &lpath, const bytes &lvalue, const bytes &path,
                const bytes &value) {
        size_t common = common_prefix(lpath, path);
        Node *branch = alloc();
        branch->kind = BRANCH;
        const bytes *paths[2] = {&lpath, &path};
        const bytes *vals[2] = {&lvalue, &value};
        for (int i = 0; i < 2; i++) {
            bytes rest = paths[i]->substr(common);
            if (rest.empty()) {
                branch->value = *vals[i];
            } else {
                branch->children[static_cast<uint8_t>(rest[0])] =
                    make_leaf(rest.substr(1), *vals[i]);
            }
        }
        if (common) return make_ext(lpath.substr(0, common), branch);
        return branch;
    }

    Node *insert(Node *node, const bytes &path, const bytes &value) {
        node = resolve(node);
        if (!node) return make_leaf(path, value);
        if (node->kind == LEAF) {
            if (node->path == path) return make_leaf(path, value);
            return split(node->path, node->value, path, value);
        }
        if (node->kind == EXT) {
            const bytes &epath = node->path;
            size_t common = common_prefix(epath, path);
            if (common == epath.size()) {
                Node *child = insert(node->child, path.substr(common), value);
                return make_ext(epath, child);
            }
            Node *branch = alloc();
            branch->kind = BRANCH;
            bytes ext_rest = epath.substr(common + 1);
            Node *sub = ext_rest.empty()
                            ? node->child
                            : make_ext(ext_rest, node->child);
            branch->children[static_cast<uint8_t>(epath[common])] = sub;
            if (common < path.size()) {
                branch->children[static_cast<uint8_t>(path[common])] =
                    make_leaf(path.substr(common + 1), value);
            } else {
                branch->value = value;
            }
            if (common) return make_ext(path.substr(0, common), branch);
            return branch;
        }
        // branch
        Node *out = alloc();
        *out = *node;
        if (path.empty()) {
            out->value = value;
            return out;
        }
        uint8_t idx = path[0];
        out->children[idx] = insert(node->children[idx], path.substr(1),
                                    value);
        return out;
    }

    Node *merge_ext(const bytes &prefix, Node *child) {
        child = resolve(child);
        if (child->kind == LEAF)
            return make_leaf(prefix + child->path, child->value);
        if (child->kind == EXT)
            return make_ext(prefix + child->path, child->child);
        return make_ext(prefix, child);
    }

    Node *collapse_branch(Node *node) {
        int live = -1, count = 0;
        for (int i = 0; i < 16; i++)
            if (node->children[i]) { live = i; count++; }
        if (count == 0) {
            if (!node->value.empty()) return make_leaf(bytes(), node->value);
            return nullptr;
        }
        if (count == 1 && node->value.empty()) {
            bytes pre(1, static_cast<char>(live));
            return merge_ext(pre, node->children[live]);
        }
        return node;
    }

    Node *remove(Node *node, const bytes &path) {
        node = resolve(node);
        if (!node) return nullptr;
        if (node->kind == LEAF)
            return node->path == path ? nullptr : node;
        if (node->kind == EXT) {
            const bytes &epath = node->path;
            if (path.compare(0, epath.size(), epath) != 0 ||
                path.size() < epath.size())
                return node;
            Node *child = remove(node->child, path.substr(epath.size()));
            if (!child) return nullptr;
            return merge_ext(epath, child);
        }
        Node *out = alloc();
        *out = *node;
        if (path.empty()) {
            out->value.clear();
        } else {
            uint8_t idx = path[0];
            if (!out->children[idx]) return node;
            out->children[idx] = remove(out->children[idx], path.substr(1));
        }
        return collapse_branch(out);
    }

    // ---- encoding / commit -------------------------------------------

    bytes encode_fields(Node *n);

    bytes child_ref(Node *n) {
        if (n->kind == REF_HASH) return rlp_encode_string(n->ref);
        if (n->kind == REF_INLINE) return n->ref;
        bytes enc = encode_fields(n);
        if (enc.size() < 32) return enc;
        bytes h = keccak(enc);
        store_node(h, enc);
        return rlp_encode_string(h);
    }

    void store_node(const bytes &h, const bytes &enc) {
        auto it = nodes.find(h);
        if (it == nodes.end()) {
            nodes.emplace(h, enc);
            fresh.push_back(enc);
        }
    }

    bytes encode(Node *n) { return encode_fields(n); }

    bytes commit(Node *root, bytes &root_hash_out) {
        if (!root) {
            // keccak(rlp("")) — the empty trie root
            bytes enc = rlp_encode_string(bytes());
            root_hash_out = keccak(enc);
            return root_hash_out;
        }
        if (root->kind == REF_HASH) {
            root_hash_out = root->ref;
            return root_hash_out;
        }
        root = resolve(root);
        bytes enc = encode_fields(root);
        bytes h = keccak(enc);
        store_node(h, enc);
        root_hash_out = h;
        return h;
    }
};

bytes Engine::encode_fields(Node *n) {
    bytes payload;
    if (n->kind == LEAF) {
        payload += rlp_encode_string(hp_encode(n->path, true));
        payload += rlp_encode_string(n->value);
    } else if (n->kind == EXT) {
        payload += rlp_encode_string(hp_encode(n->path, false));
        payload += child_ref(n->child);
    } else if (n->kind == BRANCH) {
        for (int i = 0; i < 16; i++) {
            if (n->children[i])
                payload += child_ref(n->children[i]);
            else
                payload += rlp_encode_string(bytes());
        }
        payload += rlp_encode_string(n->value);
    } else {
        throw RlpError{};
    }
    return rlp_encode_list_payload(payload);
}

bytes nibbles_of(const uint8_t *key, size_t len) {
    bytes out;
    out.reserve(len * 2);
    for (size_t i = 0; i < len; i++) {
        out.push_back(key[i] >> 4);
        out.push_back(key[i] & 0xF);
    }
    return out;
}

const char EMPTY_ROOT_HEX[] =
    "\x56\xe8\x1f\x17\x1b\xcc\x55\xa6\xff\x83\x45\xe6\x92\xc0\xf8\x6e"
    "\x5b\x48\xe0\x1b\x99\x6c\xad\xc0\x01\x62\x2f\xb5\xe3\x63\xb4\x21";

} // namespace

// ---------------------------------------------------------------------------
// C API
// ---------------------------------------------------------------------------

extern "C" {

void *mpt_new() { return new Engine(); }

void mpt_set_resolver(void *ep, resolver_fn fn) {
    static_cast<Engine *>(ep)->resolver = fn;
}

void mpt_free(void *e) { delete static_cast<Engine *>(e); }

// records: (u32 little-endian len | bytes)*
int mpt_load(void *ep, const uint8_t *data, size_t len) {
    Engine *e = static_cast<Engine *>(ep);
    size_t pos = 0;
    int n = 0;
    while (pos + 4 <= len) {
        uint32_t rl;
        std::memcpy(&rl, data + pos, 4);
        pos += 4;
        if (pos + rl > len) return -1;
        bytes raw(reinterpret_cast<const char *>(data + pos), rl);
        pos += rl;
        e->nodes.emplace(keccak(raw), std::move(raw));
        n++;
    }
    return pos == len ? n : -1;
}

// ops: (u32 klen | key | u32 vlen | value)*; vlen == 0 -> delete.
// Returns 0 ok, 1 missing nodes (mpt_missing), -1 malformed input.
int mpt_apply(void *ep, const uint8_t *root, const uint8_t *ops,
              size_t ops_len, uint8_t *new_root_out) {
    Engine *e = static_cast<Engine *>(ep);
    e->missing.clear();
    e->arena.clear();
    Node *r = nullptr;
    if (std::memcmp(root, EMPTY_ROOT_HEX, 32) != 0)
        r = e->make_ref_hash(bytes(reinterpret_cast<const char *>(root), 32));
    try {
        size_t pos = 0;
        while (pos < ops_len) {
            if (pos + 4 > ops_len) return -1;
            uint32_t klen;
            std::memcpy(&klen, ops + pos, 4);
            pos += 4;
            if (pos + klen + 4 > ops_len) return -1;
            bytes nib = nibbles_of(ops + pos, klen);
            pos += klen;
            uint32_t vlen;
            std::memcpy(&vlen, ops + pos, 4);
            pos += 4;
            if (pos + vlen > ops_len) return -1;
            if (vlen == 0) {
                r = e->remove(r, nib);
            } else {
                bytes value(reinterpret_cast<const char *>(ops + pos), vlen);
                r = e->insert(r, nib, value);
            }
            pos += vlen;
        }
        bytes h;
        e->commit(r, h);
        std::memcpy(new_root_out, h.data(), 32);
        e->arena.clear();
        return 0;
    } catch (const MissingError &m) {
        e->missing.insert(m.hash);
        // walk is aborted at the first missing node; collect the rest of
        // the frontier by dry-running every op against the current map
        // would repeat the same abort, so return what we have — the caller
        // feeds and retries (few passes per batch).
        e->arena.clear();
        return 1;
    } catch (const RlpError &) {
        e->arena.clear();
        return -2;
    }
}

// out must hold 32 * count bytes; returns the number written
int mpt_missing(void *ep, uint8_t *out, size_t cap) {
    Engine *e = static_cast<Engine *>(ep);
    size_t n = 0;
    for (const bytes &h : e->missing) {
        if ((n + 1) * 32 > cap) break;
        std::memcpy(out + n * 32, h.data(), 32);
        n++;
    }
    return static_cast<int>(n);
}

// size of the fresh-nodes drain buffer
size_t mpt_fresh_size(void *ep) {
    Engine *e = static_cast<Engine *>(ep);
    size_t total = 0;
    for (const bytes &b : e->fresh) total += 4 + b.size();
    return total;
}

// drains fresh nodes as (u32 len | bytes)*; returns count
int mpt_take_fresh(void *ep, uint8_t *out, size_t cap) {
    Engine *e = static_cast<Engine *>(ep);
    size_t pos = 0;
    int n = 0;
    for (const bytes &b : e->fresh) {
        if (pos + 4 + b.size() > cap) return -1;
        uint32_t l = static_cast<uint32_t>(b.size());
        std::memcpy(out + pos, &l, 4);
        std::memcpy(out + pos + 4, b.data(), b.size());
        pos += 4 + b.size();
        n++;
    }
    e->fresh.clear();
    return n;
}

size_t mpt_node_count(void *ep) {
    return static_cast<Engine *>(ep)->nodes.size();
}

} // extern "C"
