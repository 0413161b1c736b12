// Native cluster-state ingest: apiserver JSON -> columnar batches.
//
// The framework's one genuinely hot host-side loop outside numpy is
// decoding apiserver LIST responses (50k pods ~= 30 MB of JSON) into the
// cluster model: ~2.3 s in pure Python (json.loads + per-pod decode).
// This engine parses the same bytes into struct-of-arrays batches in one
// pass — the native runtime component backing io/native_ingest.py, used
// by the watch cache's LIST seeding (io/watch.py) and the polling client
// (io/kube.py). Python reads the arrays zero-copy via ctypes and wraps
// rows in lazy views.
//
// Reference parity (citations into the reference): the decoded fields
// mirror io/kube.py's decode_pod/decode_node, which in turn mirror what
// client-go hands the reference (nodes/nodes.go:129-165 reads pod CPU
// requests in millicores; rescheduler.go:241-256 reads ownerReferences
// for the DaemonSet filter; scaler/scaler.go:58 needs name/namespace).
// Quantity grammar follows k8s resource.Quantity (utils/quantity.py):
// decimal/binary suffixes, milli/micro/nano, exponents; CPU rounds up to
// millicores like Quantity.MilliValue, sizes floor to base units.
//
// Build: io/native_ingest.py compiles it at first use (one
// g++ -std=c++17 -O2 -fPIC -shared, no dependencies) into
// build/torch_native/, named by the hash of this source and the flags.

#include <cstdint>
#include <cstring>
#include <deque>
#include <string>
#include <string_view>
#include <unordered_map>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Minimal JSON DOM over the input buffer. String values are string_views
// into the buffer when escape-free, else decoded into arena storage.

struct Val;
using Member = std::pair<std::string_view, const Val*>;

struct Val {
  enum Kind : uint8_t { Null, Bool, Num, Str, Arr, Obj } kind = Null;
  bool b = false;
  std::string_view text;  // raw number text or string contents
  std::vector<const Val*> arr;
  std::vector<Member> obj;

  const Val* get(std::string_view key) const {
    if (kind != Obj) return nullptr;
    for (const auto& m : obj)
      if (m.first == key) return m.second;
    return nullptr;
  }
};

struct Parser {
  const char* p;
  const char* end;
  std::deque<Val> arena;
  std::deque<std::string> strings;  // storage for escape-decoded strings
  bool ok = true;

  explicit Parser(const char* buf, size_t n) : p(buf), end(buf + n) {}

  Val* make() {
    arena.emplace_back();
    return &arena.back();
  }

  void skip_ws() {
    while (p < end && (*p == ' ' || *p == '\t' || *p == '\n' || *p == '\r'))
      ++p;
  }

  bool lit(const char* s, size_t n) {
    if (size_t(end - p) < n || memcmp(p, s, n) != 0) return false;
    p += n;
    return true;
  }

  // append a unicode code point as UTF-8
  static void utf8(std::string& out, uint32_t cp) {
    if (cp < 0x80) {
      out += char(cp);
    } else if (cp < 0x800) {
      out += char(0xC0 | (cp >> 6));
      out += char(0x80 | (cp & 0x3F));
    } else if (cp < 0x10000) {
      out += char(0xE0 | (cp >> 12));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    } else {
      out += char(0xF0 | (cp >> 18));
      out += char(0x80 | ((cp >> 12) & 0x3F));
      out += char(0x80 | ((cp >> 6) & 0x3F));
      out += char(0x80 | (cp & 0x3F));
    }
  }

  bool hex4(uint32_t* out) {
    if (end - p < 4) return false;
    uint32_t v = 0;
    for (int i = 0; i < 4; i++) {
      char c = p[i];
      v <<= 4;
      if (c >= '0' && c <= '9') v |= c - '0';
      else if (c >= 'a' && c <= 'f') v |= c - 'a' + 10;
      else if (c >= 'A' && c <= 'F') v |= c - 'A' + 10;
      else return false;
    }
    p += 4;
    *out = v;
    return true;
  }

  bool parse_string(std::string_view* out) {
    if (p >= end || *p != '"') return false;
    ++p;
    const char* start = p;
    // fast path: no escapes
    while (p < end && *p != '"' && *p != '\\') ++p;
    if (p < end && *p == '"') {
      *out = std::string_view(start, p - start);
      ++p;
      return true;
    }
    // slow path: decode escapes into arena storage
    strings.emplace_back(start, p - start);
    std::string& s = strings.back();
    while (p < end && *p != '"') {
      char c = *p;
      if (c == '\\') {
        ++p;
        if (p >= end) return false;
        switch (*p) {
          case '"': s += '"'; ++p; break;
          case '\\': s += '\\'; ++p; break;
          case '/': s += '/'; ++p; break;
          case 'b': s += '\b'; ++p; break;
          case 'f': s += '\f'; ++p; break;
          case 'n': s += '\n'; ++p; break;
          case 'r': s += '\r'; ++p; break;
          case 't': s += '\t'; ++p; break;
          case 'u': {
            ++p;
            uint32_t cp;
            if (!hex4(&cp)) return false;
            if (cp >= 0xD800 && cp < 0xDC00 && end - p >= 6 && p[0] == '\\' &&
                p[1] == 'u') {
              p += 2;
              uint32_t lo;
              if (!hex4(&lo)) return false;
              cp = 0x10000 + ((cp - 0xD800) << 10) + (lo - 0xDC00);
            }
            utf8(s, cp);
            break;
          }
          default:
            return false;
        }
      } else {
        s += c;
        ++p;
      }
    }
    if (p >= end) return false;
    ++p;  // closing quote
    *out = std::string_view(s);
    return true;
  }

  const Val* parse_value(int depth = 0) {
    if (depth > 64) { ok = false; return nullptr; }
    skip_ws();
    if (p >= end) { ok = false; return nullptr; }
    char c = *p;
    Val* v = make();
    if (c == '{') {
      ++p;
      v->kind = Val::Obj;
      skip_ws();
      if (p < end && *p == '}') { ++p; return v; }
      while (true) {
        skip_ws();
        std::string_view key;
        if (!parse_string(&key)) { ok = false; return nullptr; }
        skip_ws();
        if (p >= end || *p != ':') { ok = false; return nullptr; }
        ++p;
        const Val* child = parse_value(depth + 1);
        if (!ok) return nullptr;
        v->obj.emplace_back(key, child);
        skip_ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == '}') { ++p; return v; }
        ok = false;
        return nullptr;
      }
    }
    if (c == '[') {
      ++p;
      v->kind = Val::Arr;
      skip_ws();
      if (p < end && *p == ']') { ++p; return v; }
      while (true) {
        const Val* child = parse_value(depth + 1);
        if (!ok) return nullptr;
        v->arr.push_back(child);
        skip_ws();
        if (p < end && *p == ',') { ++p; continue; }
        if (p < end && *p == ']') { ++p; return v; }
        ok = false;
        return nullptr;
      }
    }
    if (c == '"') {
      v->kind = Val::Str;
      if (!parse_string(&v->text)) { ok = false; return nullptr; }
      return v;
    }
    if (c == 't') {
      if (!lit("true", 4)) { ok = false; return nullptr; }
      v->kind = Val::Bool;
      v->b = true;
      return v;
    }
    if (c == 'f') {
      if (!lit("false", 5)) { ok = false; return nullptr; }
      v->kind = Val::Bool;
      return v;
    }
    if (c == 'n') {
      if (!lit("null", 4)) { ok = false; return nullptr; }
      return v;  // Null
    }
    // number: capture raw text (quantities parse it exactly, no doubles)
    const char* start = p;
    if (p < end && (*p == '-' || *p == '+')) ++p;
    while (p < end &&
           ((*p >= '0' && *p <= '9') || *p == '.' || *p == 'e' || *p == 'E' ||
            *p == '-' || *p == '+'))
      ++p;
    if (p == start) { ok = false; return nullptr; }
    v->kind = Val::Num;
    v->text = std::string_view(start, p - start);
    return v;
  }
};

// ---------------------------------------------------------------------------
// k8s resource.Quantity: exact integer results with k8s rounding.
// value = digits * 10^e10 * mult; cpu -> ceil(value*1000), else floor.

struct Quantity {
  __int128 num = 0;   // numerator
  __int128 den = 1;   // denominator (positive powers of 10 only)
  bool valid = false;
};

const __int128 SATURATE = (__int128)1 << 100;

bool mul_pow(__int128* v, __int128 base, int exp) {
  while (exp-- > 0) {
    *v *= base;
    if (*v > SATURATE || *v < -SATURATE) return false;
  }
  return true;
}

Quantity parse_quantity(std::string_view s) {
  Quantity q;
  // strip whitespace
  while (!s.empty() && (s.front() == ' ' || s.front() == '\t'))
    s.remove_prefix(1);
  while (!s.empty() && (s.back() == ' ' || s.back() == '\t'))
    s.remove_suffix(1);
  if (s.empty()) return q;

  // suffix
  int pow10 = 0, pow2 = 0, div10 = 0;
  auto ends = [&](const char* suf) {
    size_t n = strlen(suf);
    if (s.size() >= n && s.substr(s.size() - n) == suf) {
      s.remove_suffix(n);
      return true;
    }
    return false;
  };
  if (ends("Ki")) pow2 = 10;
  else if (ends("Mi")) pow2 = 20;
  else if (ends("Gi")) pow2 = 30;
  else if (ends("Ti")) pow2 = 40;
  else if (ends("Pi")) pow2 = 50;
  else if (ends("Ei")) pow2 = 60;
  else if (!s.empty()) {
    switch (s.back()) {
      case 'n': div10 = 9; s.remove_suffix(1); break;
      case 'u': div10 = 6; s.remove_suffix(1); break;
      case 'm': div10 = 3; s.remove_suffix(1); break;
      case 'k': pow10 = 3; s.remove_suffix(1); break;
      case 'M': pow10 = 6; s.remove_suffix(1); break;
      case 'G': pow10 = 9; s.remove_suffix(1); break;
      case 'T': pow10 = 12; s.remove_suffix(1); break;
      case 'P': pow10 = 15; s.remove_suffix(1); break;
      case 'E': pow10 = 18; s.remove_suffix(1); break;
      default: break;
    }
  }
  if (s.empty()) return q;

  bool neg = false;
  size_t i = 0;
  if (s[i] == '+' || s[i] == '-') {
    neg = s[i] == '-';
    ++i;
  }
  __int128 digits = 0;
  int frac = 0;
  bool any = false, in_frac = false;
  for (; i < s.size(); ++i) {
    char c = s[i];
    if (c >= '0' && c <= '9') {
      digits = digits * 10 + (c - '0');
      if (digits > SATURATE) return q;
      if (in_frac) ++frac;
      any = true;
    } else if (c == '.' && !in_frac) {
      in_frac = true;
    } else if ((c == 'e' || c == 'E') && any) {
      int esign = 1;
      ++i;
      if (i < s.size() && (s[i] == '+' || s[i] == '-')) {
        if (s[i] == '-') esign = -1;
        ++i;
      }
      int ev = 0;
      bool edig = false;
      for (; i < s.size(); ++i) {
        if (s[i] < '0' || s[i] > '9') return q;
        ev = ev * 10 + (s[i] - '0');
        if (ev > 40) return q;  // beyond saturation anyway
        edig = true;
      }
      if (!edig) return q;
      if (esign > 0) pow10 += ev;
      else div10 += ev;
      break;
    } else {
      return q;
    }
  }
  if (!any) return q;

  q.num = digits;
  q.den = 1;
  div10 += frac;
  // cancel common powers of 10 before saturating multiplies
  int common = pow10 < div10 ? pow10 : div10;
  pow10 -= common;
  div10 -= common;
  if (!mul_pow(&q.num, 10, pow10)) return q;
  if (!mul_pow(&q.num, 2, pow2)) return q;
  if (!mul_pow(&q.den, 10, div10)) return q;
  if (neg) q.num = -q.num;
  q.valid = true;
  return q;
}

int64_t clamp_i64(__int128 v) {
  if (v > INT64_MAX) return INT64_MAX;
  if (v < INT64_MIN) return INT64_MIN;
  return (int64_t)v;
}

// CPU -> millicores, ceil (k8s MilliValue; utils/quantity.parse_cpu_millis)
int64_t cpu_millis(const Val* v) {
  if (!v || (v->kind != Val::Str && v->kind != Val::Num)) return 0;
  Quantity q = parse_quantity(v->text);
  if (!q.valid) return 0;
  __int128 n = q.num * 1000;
  __int128 r = n >= 0 ? (n + q.den - 1) / q.den : n / q.den;
  return clamp_i64(r);
}

// sizes -> base units, floor (utils/quantity: int(num // den))
int64_t base_units(const Val* v) {
  if (!v || (v->kind != Val::Str && v->kind != Val::Num)) return 0;
  Quantity q = parse_quantity(v->text);
  if (!q.valid) return 0;
  __int128 r = q.num >= 0 ? q.num / q.den
                          : -((-q.num + q.den - 1) / q.den);  // python floor
  return clamp_i64(r);
}

int64_t as_int(const Val* v) {
  if (!v) return 0;
  if (v->kind == Val::Bool) return v->b;
  if (v->kind != Val::Num && v->kind != Val::Str) return 0;
  // integer prefix is enough (priority, disruptionsAllowed)
  return base_units(v);
}

// ---------------------------------------------------------------------------
// Output batches. String columns share one heap; each cell is (off, len).

constexpr char UNIT_SEP = '\x1f';
constexpr char REC_SEP = '\x1e';
constexpr char TERM_SEP = '\x1d';
constexpr char VAL_SEP = '\x1c';

// Interned-string tables: repeated values (node names, namespaces,
// toleration sets, label sets, nodeSelector sets, anti-affinity
// selectors) are stored once; rows carry int32 ids. At 50k pods this
// collapses ~200k string decodes into a few thousand.
enum {
  TBL_NODE = 0,
  TBL_NS,
  TBL_TOLS,
  TBL_LABELS,
  TBL_NODESEL,
  TBL_AAFF,
  TBL_NAFF,  // required node-affinity blobs (see extract_node_affinity)
  TBL_PAFF,  // required POSITIVE pod-affinity matchLabels blobs
  TBL_ZAFF,  // zone-topology anti-affinity matchLabels blobs
  TBL_PVC,   // PVC claim-name lists (REC_SEP-joined)
  TBL_SPREAD,  // canonical hard topologySpreadConstraints blobs
  TBL_PZAFF,   // required POSITIVE zone-topology pod-affinity blobs
  TBL_COUNT,
};

struct Batch {
  long count = 0;
  std::vector<int64_t> i64;      // count * NI64 column-major blocks
  std::vector<int32_t> i32;      // count * NI32
  std::vector<uint8_t> u8;       // count * NU8
  std::string heap;              // shared string storage
  std::vector<int64_t> str;      // count * nstrcols * 2 (off, len)
  std::string rv;                // list metadata.resourceVersion
  int ncols_i64 = 0, ncols_i32 = 0, ncols_u8 = 0, ncols_str = 0;

  std::vector<int64_t> tbl[TBL_COUNT];  // interned blobs: (off, len) pairs
  std::unordered_map<std::string, int32_t> intern[TBL_COUNT];

  void put_str(int col, std::string_view s) {
    str[(size_t)count * ncols_str * 2 + col * 2] = (int64_t)heap.size();
    str[(size_t)count * ncols_str * 2 + col * 2 + 1] = (int64_t)s.size();
    heap.append(s.data(), s.size());
  }

  int32_t intern_str(int family, const std::string& s) {
    auto it = intern[family].find(s);
    if (it != intern[family].end()) return it->second;
    int32_t id = (int32_t)(tbl[family].size() / 2);
    intern[family].emplace(s, id);
    tbl[family].push_back((int64_t)heap.size());
    tbl[family].push_back((int64_t)s.size());
    heap.append(s);
    return id;
  }
};

// pod columns
enum { P_CPU = 0, P_MEM, P_EPH, P_NI64 };
enum {
  P_PRIO = 0,
  P_NODEID,
  P_NSID,
  P_TOLID,
  P_LABELSID,
  P_SELID,
  P_AAFFID,
  P_NAFFID,
  P_PAFFID,
  P_ZAFFID,
  P_PVCID,
  P_SPREADID,
  P_PZAFFID,
  P_NI32,
};
enum { P_FLAGS = 0, P_NU8 };
enum { PS_NAME = 0, PS_UID, PS_NSTR };
enum {
  F_MIRROR = 1,
  F_DAEMONSET = 2,
  F_REPLICATED = 4,
  F_TERMINAL = 8,
  F_PENDING = 16,
  F_PVC = 32,      // any volume backed by a persistentVolumeClaim
  F_REQAFF = 64,   // required affinity beyond the modeled spread shape
};

// Python truthiness of a JSON value — the decode contract is "exact
// lockstep with io/kube.py", whose guards are plain `if value:` checks.
bool py_truthy(const Val* v) {
  if (!v) return false;
  switch (v->kind) {
    case Val::Null: return false;
    case Val::Bool: return v->b;
    case Val::Num: {
      std::string txt(v->text);
      return strtod(txt.c_str(), nullptr) != 0.0;
    }
    case Val::Str: return !v->text.empty();
    case Val::Arr: return !v->arr.empty();
    case Val::Obj: return !v->obj.empty();
  }
  return false;
}

// --- widened pod-affinity term selectors -----------------------
//
// Exact lockstep with io/kube.py _decode_term: explicit (cross-
// namespace) `namespaces` lists are modeled; `namespaceSelector: {}`
// is the all-namespaces "*" wildcard scope and null means "no
// selector", while label-matching namespaceSelectors stay unmodeled;
// matchLabels pairs and matchExpressions with
// In / NotIn / Exists / DoesNotExist (multi-value In/NotIn) all emit as
// requirement records. The blob carries source order and own-namespace
// scopes unresolved; canonicalization (sorting, dedup, own-ns
// resolution, matches-nothing drops) happens on the Python side
// (io/native_ingest.py _parse_affinity_terms / _resolve_terms), so no
// cross-language sort contract is needed.

enum SelVerdict { SEL_OK = 0, SEL_UNMODELED = 2 };

bool has_sep_bytes(std::string_view s);  // defined with the naff blobs

// Emit one labelSelector's requirements into *out: requirements joined
// by req_sep, fields key/op/values joined by field_sep, values joined
// by val_sep. matchLabels entries become single-value In requirements
// (duplicate keys keep the LAST value — Python dict semantics);
// matchExpressions validate exactly like io/kube.py (In/NotIn need a
// non-empty string list; Exists/DoesNotExist must carry no values).
int selector_reqs_blob(const Val* sel, char req_sep, char field_sep,
                       char val_sep, std::string* out) {
  if (!sel || sel->kind != Val::Obj) return SEL_UNMODELED;
  std::string reqs;
  bool any = false;
  std::vector<std::pair<std::string_view, std::string_view>> pairs;
  const Val* ml = sel->get("matchLabels");
  if (ml) {
    if (ml->kind != Val::Obj) return SEL_UNMODELED;
    for (const auto& m : ml->obj) {
      if (!m.second || m.second->kind != Val::Str) return SEL_UNMODELED;
      if (has_sep_bytes(m.first) || has_sep_bytes(m.second->text))
        return SEL_UNMODELED;
      bool dup = false;
      for (auto& p : pairs) {
        if (p.first == m.first) {
          p.second = m.second->text;  // JSON duplicate key: last wins
          dup = true;
        }
      }
      if (!dup) pairs.emplace_back(m.first, m.second->text);
    }
  }
  for (const auto& p : pairs) {
    if (any) reqs += req_sep;
    any = true;
    reqs.append(p.first.data(), p.first.size());
    reqs += field_sep;
    reqs += "In";
    reqs += field_sep;
    reqs.append(p.second.data(), p.second.size());
  }
  const Val* me = sel->get("matchExpressions");
  if (py_truthy(me)) {
    if (me->kind != Val::Arr) return SEL_UNMODELED;
    for (const Val* e : me->arr) {
      if (!e || e->kind != Val::Obj) return SEL_UNMODELED;
      const Val* key = e->get("key");
      const Val* op = e->get("operator");
      if (!key || key->kind != Val::Str || has_sep_bytes(key->text) ||
          !op || op->kind != Val::Str)
        return SEL_UNMODELED;
      bool exists_like =
          op->text == "Exists" || op->text == "DoesNotExist";
      bool in_like = op->text == "In" || op->text == "NotIn";
      if (!exists_like && !in_like) return SEL_UNMODELED;
      const Val* values = e->get("values");
      if (exists_like) {
        // k8s validation: Exists/DoesNotExist carry no values
        if (py_truthy(values)) return SEL_UNMODELED;
      } else {
        if (!values || values->kind != Val::Arr || values->arr.empty())
          return SEL_UNMODELED;
        for (const Val* v : values->arr) {
          if (!v || v->kind != Val::Str || has_sep_bytes(v->text))
            return SEL_UNMODELED;
        }
      }
      if (any) reqs += req_sep;
      any = true;
      reqs.append(key->text.data(), key->text.size());
      reqs += field_sep;
      reqs.append(op->text.data(), op->text.size());
      reqs += field_sep;
      if (!exists_like) {
        for (size_t vi = 0; vi < values->arr.size(); ++vi) {
          if (vi) reqs += val_sep;
          const auto& t = values->arr[vi]->text;
          reqs.append(t.data(), t.size());
        }
      }
    }
  }
  if (!any) return SEL_UNMODELED;  // empty selector: not modeled
  *out += reqs;
  return SEL_OK;
}

// One affinity term -> `ns_record REC_SEP requirement records`, the
// term encoding (io/native_ingest.py _parse_affinity_terms).
// The ns record is the explicit namespaces list joined by VAL_SEP, or
// empty for own-namespace scope.
int term_selector_blob(const Val* term, std::string* blob) {
  blob->clear();
  std::string ns_rec;
  const Val* ns_list = term->get("namespaces");
  if (py_truthy(ns_list)) {
    if (ns_list->kind != Val::Arr) return SEL_UNMODELED;
    bool first = true;
    for (const Val* x : ns_list->arr) {
      // "*" is reserved as the all-namespaces sentinel: a literal
      // entry is malformed and must not silently widen the scope
      if (!x || x->kind != Val::Str || x->text.empty() || x->text == "*" ||
          has_sep_bytes(x->text))
        return SEL_UNMODELED;
      if (!first) ns_rec += VAL_SEP;
      first = false;
      ns_rec.append(x->text.data(), x->text.size());
    }
  }
  if (const Val* ns_sel = term->get("namespaceSelector")) {
    if (ns_sel->kind == Val::Obj && ns_sel->obj.empty()) {
      // {} selects EVERY namespace: the "*" wildcard scope —
      // namespace names are DNS labels, so "*" cannot collide. It
      // subsumes any `namespaces` list.
      ns_rec = "*";
    } else if (ns_sel->kind != Val::Null) {
      // non-empty selectors match namespace LABELS (unobserved):
      // conservatively unmodeled; null is the API's "no selector"
      return SEL_UNMODELED;
    }
  }
  std::string reqs;
  int verdict = selector_reqs_blob(term->get("labelSelector"), REC_SEP,
                                   UNIT_SEP, VAL_SEP, &reqs);
  if (verdict != SEL_OK) return verdict;
  *blob = ns_rec;
  *blob += REC_SEP;
  *blob += reqs;
  return SEL_OK;
}

// podAntiAffinity: ANY number of required terms, hostname or zone
// topology, widened selectors. Never-matching terms are dropped on the
// Python parse side (io/native_ingest.py), in lockstep with io/kube.py
// decode_anti_affinity.
void extract_anti_affinity(const Val* block, std::string* host_blob,
                           std::string* zone_blob, bool* unmodeled) {
  host_blob->clear();
  zone_blob->clear();
  if (!block || block->kind != Val::Obj) return;
  const Val* req = block->get("requiredDuringSchedulingIgnoredDuringExecution");
  if (!req || !py_truthy(req)) return;
  if (req->kind != Val::Arr) {
    *unmodeled = true;
    return;
  }
  for (const Val* term : req->arr) {
    if (!term || term->kind != Val::Obj) {
      *unmodeled = true;
      host_blob->clear();  // an earlier valid term must not leak: its
      zone_blob->clear();  // symmetric presence would over-constrain
      return;              // OTHER pods on this ingest path only
    }
    const Val* topo = term->get("topologyKey");
    bool zone;
    if (topo && topo->kind == Val::Str &&
        topo->text == "kubernetes.io/hostname") {
      zone = false;
    } else if (topo && topo->kind == Val::Str &&
               topo->text == "topology.kubernetes.io/zone") {
      zone = true;
    } else {
      *unmodeled = true;
      host_blob->clear();
      zone_blob->clear();
      return;
    }
    std::string blob;
    if (term_selector_blob(term, &blob) != SEL_OK) {
      *unmodeled = true;
      host_blob->clear();
      zone_blob->clear();
      return;
    }
    std::string* slot = zone ? zone_blob : host_blob;
    if (!slot->empty()) *slot += TERM_SEP;
    *slot += blob;
  }
}

// required POSITIVE podAffinity: ANY number of required terms, hostname
// or zone topology, widened selectors; every term must hold.
// Never-matching selectors are KEPT (the carrier is exactly
// unplaceable). Lockstep: io/kube.py decode_pod_affinity.
void extract_pod_affinity(const Val* block, std::string* host_blob,
                          std::string* zone_blob, bool* unmodeled) {
  host_blob->clear();
  zone_blob->clear();
  if (!block || block->kind != Val::Obj) return;
  const Val* req = block->get("requiredDuringSchedulingIgnoredDuringExecution");
  if (!req || !py_truthy(req)) return;
  if (req->kind != Val::Arr) {
    *unmodeled = true;
    return;
  }
  for (const Val* term : req->arr) {
    if (!term || term->kind != Val::Obj) {
      *unmodeled = true;
      host_blob->clear();
      zone_blob->clear();
      return;
    }
    const Val* topo = term->get("topologyKey");
    bool zone;
    if (topo && topo->kind == Val::Str &&
        topo->text == "kubernetes.io/hostname") {
      zone = false;
    } else if (topo && topo->kind == Val::Str &&
               topo->text == "topology.kubernetes.io/zone") {
      zone = true;
    } else {
      *unmodeled = true;
      host_blob->clear();
      zone_blob->clear();
      return;
    }
    std::string blob;
    if (term_selector_blob(term, &blob) != SEL_OK) {
      *unmodeled = true;
      host_blob->clear();
      zone_blob->clear();
      return;
    }
    std::string* slot = zone ? zone_blob : host_blob;
    if (!slot->empty()) *slot += TERM_SEP;
    *slot += blob;
  }
}

// Required node-affinity, in lockstep with io/kube.py
// decode_node_affinity's MODELED/UNMODELED decisions. The blob carries
// the terms in source order — canonicalization (sorting, dedup) happens
// once on the Python side when the blob is parsed, so no cross-language
// sort-order contract is needed. Encoding (k8s label keys/values are
// control-char-free): terms '\x1d' (TERM_SEP), exprs within a term
// '\x1e' (REC_SEP), expr fields key/op/values '\x1f' (UNIT_SEP),
// values '\x1c' (VAL_SEP). Empty blob = no modeled requirement.

static const char* const kNaffOps[] = {"In",     "NotIn", "Exists",
                                       "DoesNotExist", "Gt", "Lt"};

// Unlike labels/nodeSelector (apiserver-validated label syntax),
// NodeSelectorRequirement.values are NOT validated as label values — a
// value may contain the blob separator bytes. Such requirements are
// conservatively unmodeled (in lockstep with io/kube.py
// decode_node_affinity) so the blob framing can never be corrupted.
bool has_sep_bytes(std::string_view s) {
  for (char c : s)
    if (c >= '\x1c' && c <= '\x1f') return true;
  return false;
}

// Hard topologySpreadConstraints, in exact lockstep with io/kube.py
// decode_topology_spread: each hard entry (whenUnsatisfiable absent or
// anything but the literal "ScheduleAnyway") must have a non-empty
// sep-free topologyKey (ANY label key), an integer
// maxSkew >= 1, a non-empty widened selector
// (matchLabels and/or matchExpressions with the four label operators),
// and none of the counting-modifier fields — else the whole
// pod is unmodeled. Soft entries are dropped. Blob: entries joined by
// REC_SEP; entry = topo UNIT_SEP skew UNIT_SEP reqs, reqs joined by
// TERM_SEP, req = key VAL_SEP op VAL_SEP values (VAL_SEP-joined).
// Source order; the Python side canonicalizes (sort + dedup) on parse.
// Explicit DEFAULT values of the counting-modifier fields are
// semantically identical to absence and accepted (lockstep with
// io/kube.py _spread_modifiers_default): minDomains null/1 (nil
// behaves as 1 per KEP-3022), matchLabelKeys null/[], nodeAffinityPolicy
// null/"Honor", nodeTaintsPolicy null/"Ignore". Anything else keeps the
// pod conservatively unmodeled.
bool spread_modifier_is_default(const Val* c) {
  if (const Val* v = c->get("minDomains")) {
    if (v->kind != Val::Null && !(v->kind == Val::Num && v->text == "1"))
      return false;
  }
  if (const Val* v = c->get("matchLabelKeys")) {
    if (v->kind != Val::Null && !(v->kind == Val::Arr && v->arr.empty()))
      return false;
  }
  if (const Val* v = c->get("nodeAffinityPolicy")) {
    if (v->kind != Val::Null && !(v->kind == Val::Str && v->text == "Honor"))
      return false;
  }
  if (const Val* v = c->get("nodeTaintsPolicy")) {
    if (v->kind != Val::Null && !(v->kind == Val::Str && v->text == "Ignore"))
      return false;
  }
  return true;
}

bool json_int_ge1(const Val* v) {
  // Python's json gives int only for digit literals (no '.', no
  // exponent); bool is excluded there by the isinstance(bool) guard.
  if (!v || v->kind != Val::Num) return false;
  std::string_view t = v->text;
  size_t i = (t.size() && (t[0] == '-' || t[0] == '+')) ? 1 : 0;
  if (i >= t.size()) return false;
  for (size_t j = i; j < t.size(); ++j)
    if (t[j] < '0' || t[j] > '9') return false;
  return t[0] != '-' && !(t == "0") && !(i == 1 && t == "+0");
}

void extract_topology_spread(const Val* spread, bool* unmodeled,
                             std::string* blob) {
  blob->clear();
  if (!spread || !py_truthy(spread)) return;
  if (spread->kind != Val::Arr) {
    *unmodeled = true;
    return;
  }
  std::string out;
  for (const Val* c : spread->arr) {
    if (!c || c->kind != Val::Obj) {
      *unmodeled = true;
      return;
    }
    const Val* wu = c->get("whenUnsatisfiable");
    if (wu && wu->kind == Val::Str && wu->text == "ScheduleAnyway")
      continue;  // soft: advisory only
    if (!spread_modifier_is_default(c)) {
      *unmodeled = true;
      return;
    }
    // spread topology is generic: any non-empty sep-free
    // label key — the SpreadBit verdict machinery keys counts/domains
    // by the constraint's own topology key
    const Val* topo = c->get("topologyKey");
    if (!topo || topo->kind != Val::Str || topo->text.empty() ||
        has_sep_bytes(topo->text)) {
      *unmodeled = true;
      return;
    }
    const Val* skew = c->get("maxSkew");
    if (!json_int_ge1(skew)) {
      *unmodeled = true;
      return;
    }
    // widened selector: requirements joined by TERM_SEP, each
    // `key VAL_SEP op VAL_SEP v1 VAL_SEP v2 ...` (spread is always
    // own-namespace; no ns record needed)
    std::string reqs;
    if (selector_reqs_blob(c->get("labelSelector"), TERM_SEP, VAL_SEP,
                           VAL_SEP, &reqs) != SEL_OK) {
      *unmodeled = true;
      return;
    }
    if (!out.empty()) out += REC_SEP;
    out.append(topo->text.data(), topo->text.size());
    out += UNIT_SEP;
    out.append(skew->text.data(), skew->text.size());
    out += UNIT_SEP;
    out += reqs;
  }
  *blob = out;
}

void extract_node_affinity(const Val* naff, bool* unmodeled,
                           std::string* blob) {
  blob->clear();
  if (!naff || naff->kind != Val::Obj) return;
  const Val* req = naff->get("requiredDuringSchedulingIgnoredDuringExecution");
  if (!py_truthy(req)) return;  // falsy: no requirement
  if (req->kind != Val::Obj) {
    *unmodeled = true;
    return;
  }
  const Val* term_list = req->get("nodeSelectorTerms");
  if (!term_list || term_list->kind != Val::Arr || term_list->arr.empty()) {
    *unmodeled = true;
    return;
  }
  std::string out;
  bool any_term = false;
  for (const Val* term : term_list->arr) {
    if (!term || term->kind != Val::Obj) {
      *unmodeled = true;
      return;
    }
    const Val* exprs = term->get("matchExpressions");
    const Val* fields = term->get("matchFields");
    bool have_exprs = py_truthy(exprs);
    bool have_fields = py_truthy(fields);
    if (!have_exprs && !have_fields) continue;  // empty term: drop
    if ((have_exprs && exprs->kind != Val::Arr) ||
        (have_fields && fields->kind != Val::Arr)) {
      *unmodeled = true;
      return;
    }
    std::string term_out;
    bool first_expr = true;
    if (have_fields) {
      // matchFields: metadata.name In/NotIn only (the one field selector
      // k8s defines). Emitted with the reserved FieldIn/FieldNotIn ops —
      // exact lockstep with io/kube.py decode_node_affinity.
      for (const Val* e : fields->arr) {
        if (!e || e->kind != Val::Obj) {
          *unmodeled = true;
          return;
        }
        const Val* key = e->get("key");
        const Val* op = e->get("operator");
        if (!key || key->kind != Val::Str || key->text != "metadata.name" ||
            !op || op->kind != Val::Str ||
            (op->text != "In" && op->text != "NotIn")) {
          *unmodeled = true;
          return;
        }
        const Val* values = e->get("values");
        if (!values || values->kind != Val::Arr || values->arr.empty()) {
          *unmodeled = true;
          return;
        }
        for (const Val* v : values->arr) {
          if (!v || v->kind != Val::Str || has_sep_bytes(v->text)) {
            *unmodeled = true;
            return;
          }
        }
        if (!first_expr) term_out += REC_SEP;
        first_expr = false;
        term_out += "metadata.name";
        term_out += UNIT_SEP;
        term_out += (op->text == "In") ? "FieldIn" : "FieldNotIn";
        term_out += UNIT_SEP;
        for (size_t vi = 0; vi < values->arr.size(); ++vi) {
          if (vi) term_out += VAL_SEP;
          const auto& t = values->arr[vi]->text;
          term_out.append(t.data(), t.size());
        }
      }
    }
    if (!have_exprs) {
      // term_out is necessarily non-empty here: have_fields held (else
      // the term was dropped above) and every field either appended a
      // record or returned unmodeled
      if (any_term) out += TERM_SEP;
      any_term = true;
      out += term_out;
      continue;
    }
    for (const Val* e : exprs->arr) {
      if (!e || e->kind != Val::Obj) {
        *unmodeled = true;
        return;
      }
      const Val* key = e->get("key");
      const Val* op = e->get("operator");
      if (!key || key->kind != Val::Str || !op || op->kind != Val::Str) {
        *unmodeled = true;
        return;
      }
      if (has_sep_bytes(key->text)) {
        *unmodeled = true;
        return;
      }
      bool known = false;
      for (const char* k : kNaffOps) known |= (op->text == k);
      if (!known) {
        *unmodeled = true;
        return;
      }
      const Val* values = e->get("values");
      size_t n_values = 0;
      if (values && py_truthy(values)) {
        if (values->kind != Val::Arr) {
          *unmodeled = true;
          return;
        }
        for (const Val* v : values->arr) {
          if (!v || v->kind != Val::Str || has_sep_bytes(v->text)) {
            *unmodeled = true;
            return;
          }
        }
        n_values = values->arr.size();
      }
      bool exists_op =
          op->text == "Exists" || op->text == "DoesNotExist";
      if (op->text == "Gt" || op->text == "Lt") {
        if (n_values != 1) {
          *unmodeled = true;
          return;
        }
      } else if (!exists_op && n_values == 0) {  // In/NotIn need values
        *unmodeled = true;
        return;
      }
      if (!first_expr) term_out += REC_SEP;
      first_expr = false;
      term_out.append(key->text.data(), key->text.size());
      term_out += UNIT_SEP;
      term_out.append(op->text.data(), op->text.size());
      term_out += UNIT_SEP;
      if (!exists_op) {
        for (size_t vi = 0; vi < n_values; ++vi) {
          if (vi) term_out += VAL_SEP;
          const auto& t = values->arr[vi]->text;
          term_out.append(t.data(), t.size());
        }
      }
    }
    if (term_out.empty()) continue;  // all-empty term: drop
    if (any_term) out += TERM_SEP;
    any_term = true;
    out += term_out;
  }
  if (!any_term) {
    *unmodeled = true;  // every term matches nothing: unplaceable
    return;
  }
  *blob = std::move(out);
}

// node columns
enum { N_CPU = 0, N_MEM, N_EPH, N_PODS, N_NI64 };
enum { N_READY = 0, N_UNSCHED, N_HASPODS, N_NU8 };
enum { NS_NAME = 0, NS_UID, NS_LABELS, NS_TAINTS, NS_NSTR };

// labels as k\x1fv\x1e... (k8s forbids control chars in keys/values)
void blob_kv_into(std::string* out, const Val* obj) {
  if (obj && obj->kind == Val::Obj) {
    for (const auto& m : obj->obj) {
      if (!m.second || m.second->kind != Val::Str) continue;
      out->append(m.first.data(), m.first.size());
      *out += UNIT_SEP;
      out->append(m.second->text.data(), m.second->text.size());
      *out += REC_SEP;
    }
  }
}

void blob_kv(Batch* b, int col, const Val* obj) {
  size_t start = b->heap.size();
  std::string tmp;
  blob_kv_into(&tmp, obj);
  b->heap += tmp;
  b->str[(size_t)b->count * b->ncols_str * 2 + col * 2] = (int64_t)start;
  b->str[(size_t)b->count * b->ncols_str * 2 + col * 2 + 1] =
      (int64_t)(b->heap.size() - start);
}

void field(std::string* out, const Val* obj, std::string_view key) {
  const Val* v = obj ? obj->get(key) : nullptr;
  if (v && v->kind == Val::Str) out->append(v->text.data(), v->text.size());
}

Batch* ingest_pods_impl(const char* buf, long n) {
  Parser parser(buf, (size_t)n);
  const Val* root = parser.parse_value();
  if (!parser.ok || !root || root->kind != Val::Obj) return nullptr;
  const Val* items = root->get("items");
  if (!items || items->kind != Val::Arr) return nullptr;

  auto* b = new Batch();
  b->ncols_i64 = P_NI64;
  b->ncols_i32 = P_NI32;
  b->ncols_u8 = P_NU8;
  b->ncols_str = PS_NSTR;
  size_t cnt = items->arr.size();
  b->i64.resize(cnt * P_NI64);
  b->i32.resize(cnt * P_NI32);
  b->u8.resize(cnt * P_NU8);
  b->str.resize(cnt * PS_NSTR * 2);
  b->heap.reserve((size_t)n / 8);
  if (const Val* meta = root->get("metadata"))
    if (const Val* rv = meta->get("resourceVersion"))
      if (rv->kind == Val::Str) b->rv.assign(rv->text);

  for (const Val* item : items->arr) {
    if (!item || item->kind != Val::Obj) continue;
    const Val* meta = item->get("metadata");
    const Val* spec = item->get("spec");
    const Val* status = item->get("status");
    long i = b->count;

    int64_t cpu = 0, mem = 0, eph = 0;
    if (spec) {
      if (const Val* containers = spec->get("containers")) {
        if (containers->kind == Val::Arr) {
          for (const Val* c : containers->arr) {
            const Val* res = c ? c->get("resources") : nullptr;
            const Val* req = res ? res->get("requests") : nullptr;
            if (!req || req->kind != Val::Obj) continue;
            for (const auto& m : req->obj) {
              if (m.first == "cpu") cpu += cpu_millis(m.second);
              else if (m.first == "memory") mem += base_units(m.second);
              else if (m.first == "ephemeral-storage")
                eph += base_units(m.second);
            }
          }
        }
      }
    }
    b->i64[(size_t)i * P_NI64 + P_CPU] = cpu;
    b->i64[(size_t)i * P_NI64 + P_MEM] = mem;
    b->i64[(size_t)i * P_NI64 + P_EPH] = eph;
    auto i32row = [&](int col) -> int32_t& {
      return b->i32[(size_t)i * P_NI32 + col];
    };
    i32row(P_PRIO) = (int32_t)(spec ? as_int(spec->get("priority")) : 0);

    uint8_t flags = 0;
    if (meta) {
      if (const Val* ann = meta->get("annotations"))
        if (ann->get("kubernetes.io/config.mirror")) flags |= F_MIRROR;
      if (const Val* owners = meta->get("ownerReferences")) {
        if (owners->kind == Val::Arr) {
          for (const Val* ref : owners->arr) {
            const Val* ctl = ref ? ref->get("controller") : nullptr;
            if (ctl && ctl->kind == Val::Bool && ctl->b) {
              flags |= F_REPLICATED;
              const Val* kind = ref->get("kind");
              if (kind && kind->kind == Val::Str && kind->text == "DaemonSet")
                flags |= F_DAEMONSET;
              break;  // first controller ref, like controller_ref()
            }
          }
        }
      }
    }
    std::string_view phase = "Running";
    if (status) {
      const Val* ph = status->get("phase");
      if (ph && ph->kind == Val::Str) phase = ph->text;
    }
    if (phase == "Succeeded" || phase == "Failed") flags |= F_TERMINAL;
    if (phase == "Pending") flags |= F_PENDING;
    std::string pod_ns;
    field(&pod_ns, meta, "namespace");
    if (pod_ns.empty()) pod_ns = "default";
    std::string anti_host_blob;
    std::string anti_zone_blob;
    std::string paff_blob;
    std::string pzaff_blob;
    std::string naff_blob;
    std::string pvc_blob;
    std::string spread_blob;
    if (spec) {
      bool unmodeled = false;
      const Val* affinity = spec->get("affinity");
      const Val* aff_obj =
          (affinity && affinity->kind == Val::Obj) ? affinity : nullptr;
      extract_anti_affinity(
          aff_obj ? aff_obj->get("podAntiAffinity") : nullptr,
          &anti_host_blob, &anti_zone_blob, &unmodeled);
      extract_pod_affinity(
          aff_obj ? aff_obj->get("podAffinity") : nullptr,
          &paff_blob, &pzaff_blob, &unmodeled);
      extract_node_affinity(
          aff_obj ? aff_obj->get("nodeAffinity") : nullptr,
          &unmodeled, &naff_blob);
      if (unmodeled) flags |= F_REQAFF;
      if (const Val* vols = spec->get("volumes")) {
        if (vols->kind == Val::Arr) {
          bool names_ok = true;
          for (const Val* vol : vols->arr) {
            const Val* claim = vol ? vol->get("persistentVolumeClaim") : nullptr;
            if (!claim) continue;
            flags |= F_PVC;
            // claim names feed the volume-affinity resolver; any
            // malformed (or blob-unsafe) name voids the whole list so
            // the pod can never be resolved - decode_pod lockstep
            const Val* cn =
                claim->kind == Val::Obj ? claim->get("claimName") : nullptr;
            if (!names_ok || !cn || cn->kind != Val::Str || cn->text.empty() ||
                has_sep_bytes(cn->text)) {
              names_ok = false;
              pvc_blob.clear();
              continue;
            }
            if (!pvc_blob.empty()) pvc_blob += REC_SEP;
            pvc_blob.append(cn->text.data(), cn->text.size());
          }
        }
      }
      // Hard topology-spread constraints: canonical shapes are modeled
      // (blob -> SpreadBit verdicts in the packers); anything beyond
      // stays unmodeled — exact lockstep with io/kube.py
      // decode_topology_spread.
      {
        bool spread_unmodeled = false;
        extract_topology_spread(spec->get("topologySpreadConstraints"),
                                &spread_unmodeled, &spread_blob);
        if (spread_unmodeled) {
          flags |= F_REQAFF;
          spread_blob.clear();
        }
      }
    }
    b->u8[(size_t)i * P_NU8 + P_FLAGS] = flags;

    std::string tmp;
    field(&tmp, meta, "name");
    b->put_str(PS_NAME, tmp);
    tmp.clear();
    field(&tmp, meta, "uid");
    b->put_str(PS_UID, tmp);

    i32row(P_NSID) = b->intern_str(TBL_NS, pod_ns);
    std::string tmp2;
    field(&tmp2, spec, "nodeName");
    i32row(P_NODEID) = b->intern_str(TBL_NODE, tmp2);
    tmp2.clear();
    blob_kv_into(&tmp2, meta ? meta->get("labels") : nullptr);
    i32row(P_LABELSID) = b->intern_str(TBL_LABELS, tmp2);
    tmp2.clear();
    blob_kv_into(&tmp2, spec ? spec->get("nodeSelector") : nullptr);
    i32row(P_SELID) = b->intern_str(TBL_NODESEL, tmp2);
    i32row(P_AAFFID) = b->intern_str(TBL_AAFF, anti_host_blob);
    i32row(P_NAFFID) = b->intern_str(TBL_NAFF, naff_blob);
    i32row(P_PAFFID) = b->intern_str(TBL_PAFF, paff_blob);
    i32row(P_ZAFFID) = b->intern_str(TBL_ZAFF, anti_zone_blob);
    i32row(P_PVCID) = b->intern_str(TBL_PVC, pvc_blob);
    i32row(P_SPREADID) = b->intern_str(TBL_SPREAD, spread_blob);
    i32row(P_PZAFFID) = b->intern_str(TBL_PZAFF, pzaff_blob);

    // tolerations: key\x1fvalue\x1foperator\x1feffect\x1e...
    tmp.clear();
    if (spec) {
      if (const Val* tols = spec->get("tolerations")) {
        if (tols->kind == Val::Arr) {
          for (const Val* t : tols->arr) {
            if (!t || t->kind != Val::Obj) continue;
            field(&tmp, t, "key");
            tmp += UNIT_SEP;
            field(&tmp, t, "value");
            tmp += UNIT_SEP;
            {
              std::string op;
              field(&op, t, "operator");
              tmp += op.empty() ? "Equal" : op;
            }
            tmp += UNIT_SEP;
            field(&tmp, t, "effect");
            tmp += REC_SEP;
          }
        }
      }
    }
    i32row(P_TOLID) = b->intern_str(TBL_TOLS, tmp);

    b->count++;
  }
  return b;
}

Batch* ingest_nodes_impl(const char* buf, long n) {
  Parser parser(buf, (size_t)n);
  const Val* root = parser.parse_value();
  if (!parser.ok || !root || root->kind != Val::Obj) return nullptr;
  const Val* items = root->get("items");
  if (!items || items->kind != Val::Arr) return nullptr;

  auto* b = new Batch();
  b->ncols_i64 = N_NI64;
  b->ncols_i32 = 0;
  b->ncols_u8 = N_NU8;
  b->ncols_str = NS_NSTR;
  size_t cnt = items->arr.size();
  b->i64.resize(cnt * N_NI64);
  b->u8.resize(cnt * N_NU8);
  b->str.resize(cnt * NS_NSTR * 2);
  if (const Val* meta = root->get("metadata"))
    if (const Val* rv = meta->get("resourceVersion"))
      if (rv->kind == Val::Str) b->rv.assign(rv->text);

  for (const Val* item : items->arr) {
    if (!item || item->kind != Val::Obj) continue;
    const Val* meta = item->get("metadata");
    const Val* spec = item->get("spec");
    const Val* status = item->get("status");
    long i = b->count;

    int64_t cpu = 0, mem = 0, eph = 0, pods = 0;
    bool has_pods = false;
    if (status) {
      if (const Val* alloc = status->get("allocatable")) {
        if (alloc->kind == Val::Obj) {
          for (const auto& m : alloc->obj) {
            if (m.first == "cpu") cpu = cpu_millis(m.second);
            else if (m.first == "memory") mem = base_units(m.second);
            else if (m.first == "ephemeral-storage") eph = base_units(m.second);
            else if (m.first == "pods") {
              pods = base_units(m.second);
              has_pods = true;
            }
          }
        }
      }
    }
    b->i64[(size_t)i * N_NI64 + N_CPU] = cpu;
    b->i64[(size_t)i * N_NI64 + N_MEM] = mem;
    b->i64[(size_t)i * N_NI64 + N_EPH] = eph;
    b->i64[(size_t)i * N_NI64 + N_PODS] = pods;

    bool ready = false;
    if (status) {
      if (const Val* conds = status->get("conditions")) {
        if (conds->kind == Val::Arr) {
          for (const Val* c : conds->arr) {
            const Val* t = c ? c->get("type") : nullptr;
            const Val* s = c ? c->get("status") : nullptr;
            if (t && t->kind == Val::Str && t->text == "Ready" && s &&
                s->kind == Val::Str && s->text == "True")
              ready = true;
          }
        }
      }
    }
    const Val* unsched = spec ? spec->get("unschedulable") : nullptr;
    b->u8[(size_t)i * N_NU8 + N_READY] = ready;
    b->u8[(size_t)i * N_NU8 + N_UNSCHED] =
        unsched && unsched->kind == Val::Bool && unsched->b;
    b->u8[(size_t)i * N_NU8 + N_HASPODS] = has_pods;

    std::string tmp;
    field(&tmp, meta, "name");
    b->put_str(NS_NAME, tmp);
    tmp.clear();
    field(&tmp, meta, "uid");
    b->put_str(NS_UID, tmp);
    blob_kv(b, NS_LABELS, meta ? meta->get("labels") : nullptr);

    // taints: key\x1fvalue\x1feffect\x1e...
    size_t start = b->heap.size();
    if (spec) {
      if (const Val* taints = spec->get("taints")) {
        if (taints->kind == Val::Arr) {
          for (const Val* t : taints->arr) {
            if (!t || t->kind != Val::Obj) continue;
            std::string row;
            field(&row, t, "key");
            row += UNIT_SEP;
            field(&row, t, "value");
            row += UNIT_SEP;
            {
              std::string eff;
              field(&eff, t, "effect");
              row += eff.empty() ? "NoSchedule" : eff;
            }
            row += REC_SEP;
            b->heap += row;
          }
        }
      }
    }
    b->str[(size_t)i * NS_NSTR * 2 + NS_TAINTS * 2] = (int64_t)start;
    b->str[(size_t)i * NS_NSTR * 2 + NS_TAINTS * 2 + 1] =
        (int64_t)(b->heap.size() - start);

    b->count++;
  }
  return b;
}

}  // namespace

extern "C" {

void* ingest_pods(const char* buf, long n) { return ingest_pods_impl(buf, n); }
void* ingest_nodes(const char* buf, long n) {
  return ingest_nodes_impl(buf, n);
}
void ingest_free(void* h) { delete (Batch*)h; }

long batch_count(void* h) { return ((Batch*)h)->count; }
const int64_t* batch_i64(void* h) { return ((Batch*)h)->i64.data(); }
const int32_t* batch_i32(void* h) { return ((Batch*)h)->i32.data(); }
const uint8_t* batch_u8(void* h) { return ((Batch*)h)->u8.data(); }
const int64_t* batch_str(void* h) { return ((Batch*)h)->str.data(); }
const char* batch_heap(void* h, long* len) {
  Batch* b = (Batch*)h;
  *len = (long)b->heap.size();
  return b->heap.data();
}
const char* batch_rv(void* h) { return ((Batch*)h)->rv.c_str(); }
const int64_t* batch_table(void* h, int family, long* count) {
  Batch* b = (Batch*)h;
  if (family < 0 || family >= TBL_COUNT) {
    *count = 0;
    return nullptr;
  }
  *count = (long)(b->tbl[family].size() / 2);
  return b->tbl[family].data();
}

// self-description so the Python side never hardcodes layouts twice
int pod_ncols_i64() { return P_NI64; }
int pod_ncols_i32() { return P_NI32; }
int pod_ncols_u8() { return P_NU8; }
int pod_ncols_str() { return PS_NSTR; }
int node_ncols_i64() { return N_NI64; }
int node_ncols_u8() { return N_NU8; }
int node_ncols_str() { return NS_NSTR; }
int table_count() { return TBL_COUNT; }
// Interned-blob ACCEPTANCE version: bumped whenever either the blob
// encoding OR the modeled/unmodeled decision surface changes, so a
// stale .so can never silently disagree with the Python reference
// decoder (io/native_ingest.py refuses it and falls back).
// 2 = widened affinity/spread term format;
// 3 = + namespaceSelector {} wildcard, explicit-default spread
//     modifiers, arbitrary spread topology keys.
int blob_format_version() { return 3; }

}  // extern "C"
