// fstlib: the native TLG build of the benchmark's decode graph.
//
// One entry point, fstlib_build_full: LG = minimize_encoded(
// determinize_star_log(L o G)), then T o LG compiled to degree-capped
// CSR device tables with the epsilon arcs' transitive closure.  These
// are the offline ops that the reference gets from OpenFst and its fstext
// extensions (src/fstext/determinize-star-inl.h, src/fstext/table-matcher.h,
// src/fstbin/fstminimizeencoded.cc).
//
// Input: each FST as one serialized buffer (fst_native.pack_fst):
//   int64 n_states, int64 start, int64 n_arcs,
//   int32 src[n_arcs], int32 il[n_arcs], int32 ol[n_arcs],
//   float  w[n_arcs],  int32 dst[n_arcs],
//   int64 n_finals, int32 fstate[n_finals], float fw[n_finals]
// The output is a freshly malloc'd buffer; free it with fstlib_free.

#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <cmath>
#include <vector>
#include <unordered_map>
#include <map>
#include <queue>
#include <algorithm>
#include <string>
#include <limits>

namespace {

constexpr float kInf = std::numeric_limits<float>::infinity();
constexpr int kEps = 0;

struct Arc {
  int32_t il, ol;
  float w;
  int32_t dst;
};

struct Fst {
  int64_t start = -1;
  std::vector<std::vector<Arc>> arcs;
  std::unordered_map<int32_t, float> finals;

  int64_t num_states() const { return (int64_t)arcs.size(); }
  int32_t add_state() {
    arcs.emplace_back();
    return (int32_t)arcs.size() - 1;
  }
  bool is_final(int32_t s) const { return finals.count(s) != 0; }
  float final_weight(int32_t s) const {
    auto it = finals.find(s);
    return it == finals.end() ? kInf : it->second;
  }
};

// ---------- serialization ----------

Fst unpack(const uint8_t* buf) {
  const uint8_t* p = buf;
  auto rd64 = [&]() { int64_t v; memcpy(&v, p, 8); p += 8; return v; };
  Fst f;
  int64_t n_states = rd64();
  f.start = rd64();
  int64_t n_arcs = rd64();
  f.arcs.resize(n_states);
  const int32_t* src = (const int32_t*)p; p += 4 * n_arcs;
  const int32_t* il = (const int32_t*)p; p += 4 * n_arcs;
  const int32_t* ol = (const int32_t*)p; p += 4 * n_arcs;
  const float* w = (const float*)p; p += 4 * n_arcs;
  const int32_t* dst = (const int32_t*)p; p += 4 * n_arcs;
  for (int64_t i = 0; i < n_arcs; i++)
    f.arcs[src[i]].push_back({il[i], ol[i], w[i], dst[i]});
  int64_t n_finals = rd64();
  const int32_t* fs = (const int32_t*)p; p += 4 * n_finals;
  const float* fw = (const float*)p; p += 4 * n_finals;
  for (int64_t i = 0; i < n_finals; i++) f.finals[fs[i]] = fw[i];
  return f;
}

// ---------- semiring ----------

inline float log_plus(float a, float b) {
  if (a == kInf) return b;
  if (b == kInf) return a;
  float hi = std::min(a, b), lo = std::max(a, b);  // smaller = better
  return hi - std::log1p(std::exp(hi - lo));
}

inline float trop_plus(float a, float b) { return std::min(a, b); }

// ---------- connect ----------

Fst connect(const Fst& f) {
  int64_t n = f.num_states();
  Fst out;
  if (f.start < 0 || n == 0) return out;
  std::vector<char> fwd(n, 0), bwd(n, 0);
  std::vector<int32_t> stack;
  stack.push_back((int32_t)f.start);
  fwd[f.start] = 1;
  while (!stack.empty()) {
    int32_t s = stack.back(); stack.pop_back();
    for (auto& a : f.arcs[s])
      if (!fwd[a.dst]) { fwd[a.dst] = 1; stack.push_back(a.dst); }
  }
  std::vector<std::vector<int32_t>> rev(n);
  for (int64_t s = 0; s < n; s++)
    for (auto& a : f.arcs[s]) rev[a.dst].push_back((int32_t)s);
  for (auto& kv : f.finals)
    if (fwd[kv.first] && !bwd[kv.first]) {
      bwd[kv.first] = 1; stack.push_back(kv.first);
    }
  while (!stack.empty()) {
    int32_t s = stack.back(); stack.pop_back();
    for (int32_t p : rev[s])
      if (!bwd[p]) { bwd[p] = 1; stack.push_back(p); }
  }
  std::vector<int32_t> remap(n, -1);
  for (int64_t s = 0; s < n; s++)
    if (fwd[s] && bwd[s]) remap[s] = out.add_state();
  if (remap[f.start] < 0) return Fst();
  out.start = remap[f.start];
  for (int64_t s = 0; s < n; s++) {
    if (remap[s] < 0) continue;
    for (auto& a : f.arcs[s])
      if (remap[a.dst] >= 0)
        out.arcs[remap[s]].push_back({a.il, a.ol, a.w, remap[a.dst]});
    auto it = f.finals.find((int32_t)s);
    if (it != f.finals.end()) out.finals[remap[s]] = it->second;
  }
  return out;
}

// ---------- compose (epsilon-sequencing filter, canonical A*B*) ----------

// Open-addressing uint64 -> int32 map (power-of-2 table, linear probing).
// The composition state map is THE scaling bottleneck at LM scale
// (~10M pair states); std::unordered_map's node allocations and tuple
// hashing made compose ~50x slower than memory bandwidth allows.
class FlatMap64 {
 public:
  explicit FlatMap64(size_t expect) { rehash(roundup(expect * 2)); }

  // returns the slot's value reference; inserts `fresh` if absent
  int32_t* find_or_null(uint64_t key) {
    size_t mask = table_.size() - 1;
    size_t i = hash(key) & mask;
    while (true) {
      Slot& s = table_[i];
      if (s.key == key && s.used) return &s.val;
      if (!s.used) return nullptr;
      i = (i + 1) & mask;
    }
  }

  void insert(uint64_t key, int32_t val) {
    if ((count_ + 1) * 10 >= table_.size() * 7) grow();
    size_t mask = table_.size() - 1;
    size_t i = hash(key) & mask;
    while (table_[i].used) i = (i + 1) & mask;
    table_[i] = {key, val, true};
    count_++;
  }

 private:
  struct Slot {
    uint64_t key = 0;
    int32_t val = 0;
    bool used = false;
  };
  static size_t roundup(size_t n) {
    size_t p = 64;
    while (p < n) p <<= 1;
    return p;
  }
  static size_t hash(uint64_t k) {
    k ^= k >> 33;
    k *= 0xff51afd7ed558ccdULL;
    k ^= k >> 33;
    return (size_t)k;
  }
  void rehash(size_t n) { table_.assign(n, Slot{}); }
  void grow() {
    std::vector<Slot> old;
    old.swap(table_);
    rehash(old.size() * 2);
    for (auto& s : old) {
      if (!s.used) continue;
      size_t mask = table_.size() - 1;
      size_t i = hash(s.key) & mask;
      while (table_[i].used) i = (i + 1) & mask;
      table_[i] = s;
    }
  }
  std::vector<Slot> table_;
  size_t count_ = 0;
};

Fst compose(const Fst& a, const Fst& b) {
  // Table composition: b's arcs are ilabel-sorted once (the reference's
  // TableCompose strategy, src/fstext/table-matcher.h) so each match is a
  // binary search instead of building a per-visit hash map.  The pair
  // state table is a flat open-addressing map keyed by the packed
  // (sa, sb, filter) triple; the work stack carries (key, id) so no
  // lookup repeats on pop.
  Fst out;
  if (a.start < 0 || b.start < 0) return out;

  std::vector<std::vector<Arc>> b_sorted(b.arcs.size());
  for (size_t s = 0; s < b.arcs.size(); s++) {
    b_sorted[s] = b.arcs[s];
    std::stable_sort(
        b_sorted[s].begin(), b_sorted[s].end(),
        [](const Arc& x, const Arc& y) { return x.il < y.il; });
  }
  auto match_range = [&](int32_t sb, int32_t il)
      -> std::pair<const Arc*, const Arc*> {
    const auto& arcs = b_sorted[sb];
    Arc probe{il, 0, 0.0f, 0};
    auto lo = std::lower_bound(
        arcs.begin(), arcs.end(), probe,
        [](const Arc& x, const Arc& y) { return x.il < y.il; });
    auto hi = std::upper_bound(
        arcs.begin(), arcs.end(), probe,
        [](const Arc& x, const Arc& y) { return x.il < y.il; });
    return {arcs.data() + (lo - arcs.begin()),
            arcs.data() + (hi - arcs.begin())};
  };

  // (sa, sb, flt) packed: sa/sb < 2^31, flt in {0,1,2}
  auto pack_key = [](int32_t sa, int32_t sb, int8_t flt) -> uint64_t {
    return ((uint64_t)(uint32_t)sa << 33) | ((uint64_t)(uint32_t)sb << 2) |
           (uint64_t)flt;
  };
  FlatMap64 ids(a.num_states() + b.num_states());
  struct Todo { int32_t sa, sb, id; int8_t flt; };
  std::vector<Todo> stack;
  int64_t n_out = 0;
  auto get_state = [&](int32_t sa, int32_t sb, int8_t flt) {
    uint64_t k = pack_key(sa, sb, flt);
    if (int32_t* v = ids.find_or_null(k)) return *v;
    int32_t id = (int32_t)n_out++;
    ids.insert(k, id);
    stack.push_back({sa, sb, id, flt});
    return id;
  };
  // each pair state is expanded exactly once, so its arcs land
  // contiguously in ONE flat arena (5M+ per-state vectors thrash the
  // allocator at LM scale); per-state (offset, count) index the arena
  std::vector<Arc> arena;
  arena.reserve(a.num_states() * 4);
  std::vector<std::pair<int64_t, int32_t>> spans;
  auto note_span = [&](int32_t id, int64_t off) {
    if ((int64_t)spans.size() <= id) spans.resize(id + 1, {0, 0});
    spans[id] = {off, (int32_t)(arena.size() - off)};
  };
  int32_t start_id = get_state((int32_t)a.start, (int32_t)b.start, 0);
  while (!stack.empty()) {
    auto [sa, sb, cur, flt] = stack.back(); stack.pop_back();
    if (a.is_final(sa) && b.is_final(sb))
      out.finals[cur] = a.final_weight(sa) + b.final_weight(sb);
    int64_t off = (int64_t)arena.size();
    for (auto& aa : a.arcs[sa]) {
      if (aa.ol == kEps) {
        if (flt == 0 || flt == 1) {
          int32_t nxt = get_state(aa.dst, sb, 1);
          arena.push_back({aa.il, kEps, aa.w, nxt});
        }
      } else {
        auto [lo, hi] = match_range(sb, aa.ol);
        for (const Arc* ab = lo; ab != hi; ++ab) {
          int32_t nxt = get_state(aa.dst, ab->dst, 0);
          arena.push_back({aa.il, ab->ol, aa.w + ab->w, nxt});
        }
      }
    }
    auto [elo, ehi] = match_range(sb, kEps);
    for (const Arc* ab = elo; ab != ehi; ++ab) {
      int32_t nxt = get_state(sa, ab->dst, 2);
      arena.push_back({kEps, ab->ol, ab->w, nxt});
    }
    note_span(cur, off);
  }
  out.start = start_id;
  out.arcs.resize(n_out);
  spans.resize(n_out, {0, 0});
  for (int64_t s = 0; s < n_out; s++) {
    auto [off, cnt] = spans[s];
    out.arcs[s].assign(arena.begin() + off, arena.begin() + off + cnt);
  }
  return connect(out);
}

// ---------- determinize-star ----------

struct Element {
  int32_t state;
  float w;
  std::vector<int32_t> str;
  bool operator<(const Element& o) const {
    if (state != o.state) return state < o.state;
    if (w != o.w) return w < o.w;
    return str < o.str;
  }
};

std::string subset_key(const std::vector<Element>& subset) {
  std::string k;
  k.reserve(subset.size() * 16);
  for (auto& e : subset) {
    k.append((const char*)&e.state, 4);
    // round weight for stable hashing (mirrors python round(w, 9) intent)
    float rw = std::round(e.w * 1e6f) / 1e6f;
    k.append((const char*)&rw, 4);
    int32_t len = (int32_t)e.str.size();
    k.append((const char*)&len, 4);
    k.append((const char*)e.str.data(), e.str.size() * 4);
  }
  return k;
}

void emit_chain(Fst& out, int32_t src, int32_t dst, int32_t il,
                const std::vector<int32_t>& ostr, float w) {
  if (ostr.empty()) {
    out.arcs[src].push_back({il, kEps, w, dst});
    return;
  }
  int32_t cur = src;
  for (size_t k = 0; k < ostr.size(); k++) {
    bool last = k + 1 == ostr.size();
    int32_t nxt = last ? dst : out.add_state();
    out.arcs[cur].push_back({k == 0 ? il : kEps, ostr[k],
                             k == 0 ? w : 0.0f, nxt});
    cur = nxt;
  }
}

Fst determinize_star(const Fst& f, bool log_semiring,
                     int64_t max_states, bool* ok) {
  *ok = true;
  if (f.start < 0 || f.num_states() == 0) return Fst{};  // empty input
  auto plus = log_semiring ? log_plus : trop_plus;

  struct PairHash {
    size_t operator()(const std::pair<int32_t, std::string>& p) const {
      return std::hash<std::string>()(p.second) * 31 + p.first;
    }
  };

  auto eps_closure = [&](std::vector<Element> subset) {
    std::unordered_map<std::pair<int32_t, std::string>, float, PairHash> best;
    std::vector<Element> work(subset.begin(), subset.end());
    int64_t iters = 0;
    while (!work.empty()) {
      if (++iters > 2000000) { *ok = false; return std::vector<Element>{}; }
      Element e = std::move(work.back()); work.pop_back();
      std::string skey((const char*)e.str.data(), e.str.size() * 4);
      auto key = std::make_pair(e.state, skey);
      auto it = best.find(key);
      float old = it == best.end() ? kInf : it->second;
      float nw = plus(old, e.w);
      bool improved = it == best.end() ||
          (log_semiring ? std::fabs(nw - old) > 1e-12f : nw < old - 1e-12f);
      if (!improved && it != best.end()) continue;
      best[key] = nw;
      for (auto& a : f.arcs[e.state]) {
        if (a.il == kEps) {
          Element ne;
          ne.state = a.dst;
          ne.w = nw + a.w;
          ne.str = e.str;
          if (a.ol != kEps) ne.str.push_back(a.ol);
          // a simple eps path emits at most num_states() outputs; a
          // longer string means an eps cycle with output — the input is
          // not determinizable (Kaldi's DeterminizeStar throws here);
          // fail fast instead of growing (state, string) keys forever
          if ((int64_t)ne.str.size() > f.num_states()) {
            *ok = false;
            return std::vector<Element>{};
          }
          work.push_back(std::move(ne));
        }
      }
    }
    std::vector<Element> outv;
    outv.reserve(best.size());
    for (auto& [key, w] : best) {
      Element e;
      e.state = key.first;
      e.w = w;
      e.str.resize(key.second.size() / 4);
      if (!key.second.empty())
        memcpy(e.str.data(), key.second.data(), key.second.size());
      outv.push_back(std::move(e));
    }
    return outv;
  };

  // normalize: factor common weight + common output prefix
  auto normalize = [&](std::vector<Element>& subset, float* common_w,
                       std::vector<int32_t>* prefix) {
    float cw;
    if (!log_semiring) {
      cw = kInf;
      for (auto& e : subset) cw = std::min(cw, e.w);
    } else {
      cw = kInf;
      for (auto& e : subset) cw = log_plus(cw, e.w);
    }
    std::vector<int32_t> pre = subset[0].str;
    for (auto& e : subset) {
      size_t k = 0;
      while (k < pre.size() && k < e.str.size() && pre[k] == e.str[k]) k++;
      pre.resize(k);
    }
    for (auto& e : subset) {
      e.w -= cw;
      e.str.erase(e.str.begin(), e.str.begin() + pre.size());
    }
    std::sort(subset.begin(), subset.end());
    *common_w = cw;
    *prefix = pre;
  };

  Fst out;
  std::unordered_map<std::string, int32_t> subset_ids;
  std::vector<std::vector<Element>> todo;

  auto get_id = [&](std::vector<Element>& norm, bool* fresh) {
    std::string key = subset_key(norm);
    auto it = subset_ids.find(key);
    if (it != subset_ids.end()) { *fresh = false; return it->second; }
    int32_t sid = out.add_state();
    subset_ids.emplace(std::move(key), sid);
    *fresh = true;
    return sid;
  };

  std::vector<Element> init{{(int32_t)f.start, 0.0f, {}}};
  auto closed = eps_closure(init);
  if (!*ok || closed.empty()) return out;
  float w0; std::vector<int32_t> p0;
  normalize(closed, &w0, &p0);
  bool fresh;
  int32_t sid0 = get_id(closed, &fresh);
  if (w0 != 0.0f || !p0.empty()) {
    int32_t real_start = out.add_state();
    out.start = real_start;
    emit_chain(out, real_start, sid0, kEps, p0, w0);
  } else {
    out.start = sid0;
  }
  todo.push_back(closed);

  while (!todo.empty()) {
    std::vector<Element> norm = std::move(todo.back()); todo.pop_back();
    std::string key = subset_key(norm);
    int32_t sid = subset_ids[key];
    if ((int64_t)subset_ids.size() > max_states) { *ok = false; return out; }
    // finals
    std::map<std::vector<int32_t>, float> final_strings;
    for (auto& e : norm) {
      auto fit = f.finals.find(e.state);
      if (fit != f.finals.end()) {
        float total = e.w + fit->second;
        auto it = final_strings.find(e.str);
        final_strings[e.str] =
            it == final_strings.end() ? total : plus(it->second, total);
      }
    }
    for (auto& [ostr, w] : final_strings) {
      if (ostr.empty()) {
        auto it = out.finals.find(sid);
        out.finals[sid] = it == out.finals.end() ? w : plus(it->second, w);
      } else {
        int32_t fstate = out.add_state();
        out.finals[fstate] = 0.0f;
        emit_chain(out, sid, fstate, kEps, ostr, w);
      }
    }
    // transitions grouped by input label
    std::map<int32_t, std::vector<Element>> by_label;
    for (auto& e : norm)
      for (auto& a : f.arcs[e.state])
        if (a.il != kEps) {
          Element ne;
          ne.state = a.dst;
          ne.w = e.w + a.w;
          ne.str = e.str;
          if (a.ol != kEps) ne.str.push_back(a.ol);
          by_label[a.il].push_back(std::move(ne));
        }
    for (auto& [il, lst] : by_label) {
      auto cl = eps_closure(lst);
      if (!*ok) return out;
      float cw; std::vector<int32_t> pre;
      normalize(cl, &cw, &pre);
      bool is_fresh;
      int32_t nid = get_id(cl, &is_fresh);
      emit_chain(out, sid, nid, il, pre, cw);
      if (is_fresh) todo.push_back(std::move(cl));
    }
  }
  return out;
}

// ---------- minimize_encoded ----------

Fst minimize_encoded(const Fst& f) {
  int64_t n = f.num_states();
  if (n == 0) return f;
  // encode arcs
  std::map<std::tuple<int32_t, int32_t, int64_t>, int32_t> enc;
  auto code = [&](const Arc& a) {
    int64_t wq = (int64_t)std::llround((double)a.w * 1e7);
    auto key = std::make_tuple(a.il, a.ol, wq);
    auto it = enc.find(key);
    if (it != enc.end()) return it->second;
    int32_t c = (int32_t)enc.size();
    enc.emplace(key, c);
    return c;
  };
  std::vector<std::vector<std::pair<int32_t, int32_t>>> arcs_enc(n);
  for (int64_t s = 0; s < n; s++) {
    for (auto& a : f.arcs[s]) arcs_enc[s].push_back({code(a), a.dst});
    std::sort(arcs_enc[s].begin(), arcs_enc[s].end());
  }
  std::vector<int32_t> part(n);
  {
    std::map<int64_t, int32_t> blocks;
    for (int64_t s = 0; s < n; s++) {
      float fw = f.final_weight((int32_t)s);
      int64_t key = std::isinf(fw) ? INT64_MIN
                                   : (int64_t)std::llround((double)fw * 1e7);
      auto it = blocks.find(key);
      if (it == blocks.end()) it = blocks.emplace(key, (int32_t)blocks.size()).first;
      part[s] = it->second;
    }
  }
  size_t n_blocks = 0;
  while (true) {
    std::unordered_map<std::string, int32_t> sig;
    std::vector<int32_t> new_part(n);
    for (int64_t s = 0; s < n; s++) {
      std::string key;
      key.append((const char*)&part[s], 4);
      for (auto& [c, d] : arcs_enc[s]) {
        key.append((const char*)&c, 4);
        key.append((const char*)&part[d], 4);
      }
      auto it = sig.find(key);
      if (it == sig.end()) it = sig.emplace(std::move(key), (int32_t)sig.size()).first;
      new_part[s] = it->second;
    }
    bool stable = sig.size() == n_blocks;
    n_blocks = sig.size();
    part = std::move(new_part);
    if (stable) break;
  }
  Fst out;
  std::vector<int32_t> rep(n_blocks, -1);
  for (int64_t s = 0; s < n; s++)
    if (rep[part[s]] < 0) rep[part[s]] = out.add_state();
  out.start = rep[part[f.start]];
  std::vector<char> done(n_blocks, 0);
  for (int64_t s = 0; s < n; s++) {
    int32_t b = part[s];
    if (done[b]) continue;
    done[b] = 1;
    for (auto& a : f.arcs[s])
      out.arcs[rep[b]].push_back({a.il, a.ol, a.w, rep[part[a.dst]]});
    auto it = f.finals.find((int32_t)s);
    if (it != f.finals.end()) out.finals[rep[b]] = it->second;
  }
  return connect(out);
}

// ---------- graph compilation to device tables ----------
//
// Degree-capped CSR arc tables + hub extraction + eps transitive closure.
// The reference decodes on the CPU over OpenFst structures
// (src/decoder/lattice-faster-decoder.cc); the device search needs
// static-shape dense tables, built here for LM-scale graphs.

struct CompiledBuf {
  std::vector<uint8_t> buf;
  template <typename T>
  void put(const T* p, size_t count) {
    const uint8_t* b = (const uint8_t*)p;
    buf.insert(buf.end(), b, b + count * sizeof(T));
  }
  void put64(int64_t v) { put(&v, 1); }
};

Fst cap_degree(const Fst& in, int max_degree) {
  Fst out = in;
  size_t s = 0;
  while (s < out.arcs.size()) {
    if ((int)out.arcs[s].size() > max_degree) {
      std::vector<Arc> arcs = std::move(out.arcs[s]);
      std::vector<Arc> new_arcs;
      for (size_t i = 0; i < arcs.size(); i += max_degree) {
        int32_t aux = out.add_state();
        size_t hi = std::min(arcs.size(), i + max_degree);
        out.arcs[aux].assign(arcs.begin() + i, arcs.begin() + hi);
        new_arcs.push_back({kEps, kEps, 0.0f, aux});
      }
      out.arcs[s] = std::move(new_arcs);
      if ((int)out.arcs[s].size() <= max_degree) s++;
      // else: revisit s, re-splitting the group arcs level by level
    } else {
      s++;
    }
  }
  return out;
}

int fst_eps_depth(const std::vector<std::vector<Arc>>& eps_rows, int cap) {
  int64_t n = (int64_t)eps_rows.size();
  std::vector<int32_t> depth(n, 0);
  for (int it = 0; it < cap; it++) {
    bool changed = false;
    for (int64_t s = 0; s < n; s++)
      for (auto& a : eps_rows[s]) {
        int32_t d = depth[s] + 1;
        if (d > depth[a.dst]) { depth[a.dst] = d; changed = true; }
      }
    if (!changed) {
      int32_t m = 0;
      for (auto d : depth) m = std::max(m, d);
      return m;
    }
  }
  return cap;
}

struct ClosureEnt { int32_t dst; float w; int32_t ol; };

// reverse-topological closure DP; returns per-state entries sorted by
// (dst, w, ol) and writes the max out-degree.  Mirrors Python
// _eps_closure_tables exactly (including the cycle-fallback's absence:
// caller guarantees a DAG; on a cycle we relax depth_cap rounds).
std::vector<std::vector<ClosureEnt>> eps_closure(
    const std::vector<std::vector<Arc>>& rows, int* max_deg) {
  int64_t n = (int64_t)rows.size();
  std::vector<int64_t> indeg(n, 0);
  for (int64_t s = 0; s < n; s++)
    for (auto& a : rows[s]) indeg[a.dst]++;
  std::vector<int32_t> order;
  order.reserve(n);
  for (int64_t s = 0; s < n; s++)
    if (indeg[s] == 0) order.push_back((int32_t)s);
  for (size_t head = 0; head < order.size(); head++)
    for (auto& a : rows[order[head]])
      if (--indeg[a.dst] == 0) order.push_back(a.dst);

  std::vector<std::vector<ClosureEnt>> closure(n);
  std::unordered_map<int32_t, int32_t> idx;
  if ((int64_t)order.size() == n) {
    for (int64_t i = n - 1; i >= 0; i--) {
      int32_t s = order[i];
      std::vector<ClosureEnt> ent;
      idx.clear();
      auto relax = [&](int32_t dst, float w, int32_t ol) {
        auto it = idx.find(dst);
        if (it == idx.end()) {
          idx[dst] = (int32_t)ent.size();
          ent.push_back({dst, w, ol});
        } else if (w < ent[it->second].w - 1e-12) {
          ent[it->second] = {dst, w, ol};
        }
      };
      for (auto& a : rows[s]) {
        relax(a.dst, a.w, a.ol);
        for (auto& e : closure[a.dst])
          relax(e.dst, a.w + e.w, a.ol ? a.ol : e.ol);
      }
      closure[s] = std::move(ent);
    }
  } else {
    // eps cycle guard: bounded relaxation (matches Python fallback)
    std::vector<std::unordered_map<int32_t, std::pair<float, int32_t>>> cm(n);
    for (int64_t s = 0; s < n; s++)
      for (auto& a : rows[s]) {
        auto it = cm[s].find(a.dst);
        if (it == cm[s].end() || a.w < it->second.first)
          cm[s][a.dst] = {a.w, a.ol};
      }
    for (int r = 0; r < 64; r++) {
      bool changed = false;
      for (int64_t s = 0; s < n; s++) {
        auto items = std::vector<std::pair<int32_t, std::pair<float, int32_t>>>(
            cm[s].begin(), cm[s].end());
        for (auto& [mid, wo] : items)
          for (auto& [dst, wo2] : cm[mid]) {
            float w = wo.first + wo2.first;
            int32_t o = wo.second ? wo.second : wo2.second;
            auto it = cm[s].find(dst);
            if (it == cm[s].end() || w < it->second.first - 1e-12) {
              cm[s][dst] = {w, o};
              changed = true;
            }
          }
      }
      if (!changed) break;
    }
    for (int64_t s = 0; s < n; s++)
      for (auto& [dst, wo] : cm[s])
        closure[s].push_back({dst, wo.first, wo.second});
  }
  int md = 0;
  for (int64_t s = 0; s < n; s++) {
    std::sort(closure[s].begin(), closure[s].end(),
              [](const ClosureEnt& a, const ClosureEnt& b) {
                if (a.dst != b.dst) return a.dst < b.dst;
                if (a.w != b.w) return a.w < b.w;
                return a.ol < b.ol;
              });
    md = std::max(md, (int)closure[s].size());
  }
  *max_deg = md;
  return closure;
}

// Buffer layout (all little-endian):
//   int64[12]: n, start, Ee, En, H, Eh, has_closure, Ec,
//              max_emit_deg, max_eps_deg, eps_depth, max_closure_deg
//   int32 emit_offsets[n+1]; int32 il[Ee], ol[Ee]; f32 w[Ee]; int32 dst[Ee]
//   int32 eps_offsets[n+1];  int32 ol[En]; f32 w[En]; int32 dst[En]
//   f32 final[n]
//   int32 hub_src[H]; int32 hub_offsets[H+1]; int32 hub_packed[Eh*4]
//   (if has_closure) int32 closure_offsets[n+1]; int32 closure_packed[Ec*4]
uint8_t* compile_graph_native(const Fst& in, int max_degree,
                              int hub_threshold, int build_closure,
                              size_t* out_len) {
  Fst g = in;
  std::vector<int32_t> hub_src;
  std::vector<std::vector<Arc>> hub_rows;
  if (hub_threshold > 0) {
    for (int64_t s = 0; s < g.num_states(); s++) {
      int emit = 0;
      for (auto& a : g.arcs[s]) emit += (a.il != kEps);
      if (emit >= hub_threshold) {
        hub_src.push_back((int32_t)s);
        std::vector<Arc> keep, moved;
        for (auto& a : g.arcs[s])
          (a.il != kEps ? moved : keep).push_back(a);
        hub_rows.push_back(std::move(moved));
        g.arcs[s] = std::move(keep);
      }
    }
  }
  Fst capped = cap_degree(g, max_degree);
  int64_t n = capped.num_states();

  std::vector<std::vector<Arc>> emit_rows(n), eps_rows(n);
  for (int64_t s = 0; s < n; s++)
    for (auto& a : capped.arcs[s])
      (a.il == kEps ? eps_rows : emit_rows)[s].push_back(a);

  int64_t ee = 0, en = 0;
  int max_e = 0, max_n = 0;
  for (int64_t s = 0; s < n; s++) {
    ee += (int64_t)emit_rows[s].size();
    en += (int64_t)eps_rows[s].size();
    max_e = std::max(max_e, (int)emit_rows[s].size());
    max_n = std::max(max_n, (int)eps_rows[s].size());
  }
  int depth = fst_eps_depth(eps_rows, 64);

  std::vector<std::vector<ClosureEnt>> closure;
  int64_t ec = 0;
  int max_c = 0;
  if (build_closure) {
    closure = eps_closure(eps_rows, &max_c);
    for (auto& c : closure) ec += (int64_t)c.size();
  }
  int64_t eh = 0;
  for (auto& r : hub_rows) eh += (int64_t)r.size();

  // fail fast before packing: every table is int32-indexed on device;
  // a closure blow-up (dense backoff graphs) or a >2^31-arc graph must
  // surface as an error, not a corrupt buffer (negative lengths on the
  // Python side).
  const int64_t kMax = 2147000000;
  if (n >= kMax || ee >= kMax || en >= kMax || ec >= kMax || eh >= kMax) {
    *out_len = 0;
    return nullptr;
  }

  CompiledBuf cb;
  cb.buf.reserve(96 + (n + 1) * 8 + ee * 16 + en * 12 + n * 4 +
                 hub_src.size() * 8 + eh * 16 + (build_closure ? (n + 1) * 4 + ec * 16 : 0));
  int64_t hdr[12] = {n, capped.start, ee, en, (int64_t)hub_src.size(), eh,
                     (int64_t)(build_closure != 0), ec,
                     (int64_t)max_e, (int64_t)max_n, (int64_t)depth,
                     (int64_t)max_c};
  cb.put(hdr, 12);

  auto put_csr = [&](const std::vector<std::vector<Arc>>& rows,
                     bool with_il) {
    std::vector<int32_t> offs(n + 1, 0);
    for (int64_t s = 0; s < n; s++)
      offs[s + 1] = offs[s] + (int32_t)rows[s].size();
    cb.put(offs.data(), n + 1);
    std::vector<int32_t> tmp;
    int64_t e = offs[n];
    if (with_il) {
      tmp.clear(); tmp.reserve(e);
      for (int64_t s = 0; s < n; s++)
        for (auto& a : rows[s]) tmp.push_back(a.il);
      cb.put(tmp.data(), e);
    }
    tmp.clear(); tmp.reserve(e);
    for (int64_t s = 0; s < n; s++)
      for (auto& a : rows[s]) tmp.push_back(a.ol);
    cb.put(tmp.data(), e);
    std::vector<float> tw; tw.reserve(e);
    for (int64_t s = 0; s < n; s++)
      for (auto& a : rows[s]) tw.push_back(a.w);
    cb.put(tw.data(), e);
    tmp.clear(); tmp.reserve(e);
    for (int64_t s = 0; s < n; s++)
      for (auto& a : rows[s]) tmp.push_back(a.dst);
    cb.put(tmp.data(), e);
  };
  put_csr(emit_rows, true);
  put_csr(eps_rows, false);

  std::vector<float> fin(n, kInf);
  for (auto& kv : capped.finals) fin[kv.first] = kv.second;
  cb.put(fin.data(), n);

  cb.put(hub_src.data(), hub_src.size());
  std::vector<int32_t> hoffs(hub_src.size() + 1, 0);
  for (size_t i = 0; i < hub_rows.size(); i++)
    hoffs[i + 1] = hoffs[i] + (int32_t)hub_rows[i].size();
  cb.put(hoffs.data(), hoffs.size());
  std::vector<int32_t> hp;
  hp.reserve(eh * 4);
  for (auto& r : hub_rows)
    for (auto& a : r) {
      hp.push_back(a.il); hp.push_back(a.ol);
      int32_t wb; memcpy(&wb, &a.w, 4);
      hp.push_back(wb); hp.push_back(a.dst);
    }
  cb.put(hp.data(), hp.size());

  if (build_closure) {
    std::vector<int32_t> coffs(n + 1, 0);
    for (int64_t s = 0; s < n; s++)
      coffs[s + 1] = coffs[s] + (int32_t)closure[s].size();
    cb.put(coffs.data(), n + 1);
    std::vector<int32_t> cp;
    cp.reserve(ec * 4);
    for (int64_t s = 0; s < n; s++)
      for (auto& e : closure[s]) {
        cp.push_back(0); cp.push_back(e.ol);
        int32_t wb; memcpy(&wb, &e.w, 4);
        cp.push_back(wb); cp.push_back(e.dst);
      }
    cb.put(cp.data(), cp.size());
  }

  *out_len = cb.buf.size();
  uint8_t* out = (uint8_t*)malloc(cb.buf.size());
  memcpy(out, cb.buf.data(), cb.buf.size());
  return out;
}

}  // namespace

// ---------- C ABI ----------

extern "C" {

// Full graph build in ONE call: LG = minimize(determinize_star_log(
// L o G)); out = device tables of compose(T, LG).  Only L/G/T cross the
// Python boundary (the 10M-arc LG round trip through Python objects
// cost ~1.5 min at WSJ-tg scale on the split path).
int fstlib_build_full(const uint8_t* in_t, const uint8_t* in_l,
                      const uint8_t* in_g,
                      int max_degree, int hub_threshold, int build_closure,
                      uint8_t** out, size_t* out_len) {
  if (max_degree < 2) return -1;
  bool ok = true;
  Fst lg = compose(unpack(in_l), unpack(in_g));
  lg = determinize_star(lg, true, 50000000, &ok);
  if (!ok) return -2;
  lg = minimize_encoded(lg);
  Fst tlg = compose(unpack(in_t), lg);
  *out = compile_graph_native(tlg, max_degree, hub_threshold,
                              build_closure, out_len);
  return *out ? 0 : -3;
}

void fstlib_free(uint8_t* p) { free(p); }

}  // extern "C"
