// n-gram language model: modified-Kneser-Ney training + ARPA I/O + queries.
//
// Native replacement for the reference's KenLM dependency (reference:
// src/coral/ngram.py:42-177, which downloads and cmake-compiles KenLM at runtime
// and shells out to `lmplz -o N --prune 0 1 1...`). This implements the same
// estimation pipeline natively:
//
//   - interpolated modified Kneser-Ney with per-order discounts D1/D2/D3+
//     estimated from counts-of-counts (Chen & Goodman / lmplz defaults);
//   - adjusted (continuation) counts for the lower orders, except <s>-initial
//     n-grams which keep raw counts;
//   - per-order count pruning with the discounted mass of pruned entries
//     redistributed into the context's backoff weight (model stays normalised);
//   - ARPA output with a proper </s> unigram, making the reference's
//     post-hoc "</s> injection" hack (ngram.py:149-169) unnecessary;
//   - a hash-table query engine with standard backoff semantics, shared with
//     the CTC beam-search decoder (ctc_beam.cc) for shallow fusion.
//
// Exposed through a C ABI consumed via ctypes (no pybind11 in this image).

#include <stdlib.h>

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <filesystem>
#include <fstream>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace coral {

using WordId = uint32_t;

static const char* kBOS = "<s>";
static const char* kEOS = "</s>";
static const char* kUNK = "<unk>";

// Pack a word-id sequence into a byte-string key (hashable, collision-free).
static std::string PackKey(const WordId* ids, int n) {
  return std::string(reinterpret_cast<const char*>(ids), n * sizeof(WordId));
}

struct Entry {
  float logprob = 0.0f;   // log10
  float backoff = 0.0f;   // log10
};

struct Vocab {
  std::unordered_map<std::string, WordId> ids;
  std::vector<std::string> words;

  WordId GetOrAdd(const std::string& w) {
    auto it = ids.find(w);
    if (it != ids.end()) return it->second;
    WordId id = static_cast<WordId>(words.size());
    ids.emplace(w, id);
    words.push_back(w);
    return id;
  }
  int Find(const std::string& w) const {
    auto it = ids.find(w);
    return it == ids.end() ? -1 : static_cast<int>(it->second);
  }
};

struct Model {
  int order = 3;
  Vocab vocab;
  // tables[n-1]: n-gram key -> entry
  std::vector<std::unordered_map<std::string, Entry>> tables;
  WordId bos = 0, eos = 0, unk = 0;

  // Standard ARPA backoff query: log10 p(w | context), context length <= order-1.
  float Score(const std::vector<WordId>& context, WordId word) const {
    int max_ctx = order - 1;
    int start = std::max(0, static_cast<int>(context.size()) - max_ctx);
    std::vector<WordId> ctx(context.begin() + start, context.end());
    // Try longest match first; accumulate backoff on the way down.
    float backoff_sum = 0.0f;
    for (int use = static_cast<int>(ctx.size()); use >= 0; --use) {
      std::vector<WordId> key(ctx.end() - use, ctx.end());
      key.push_back(word);
      const auto& table = tables[use];
      auto it = table.find(PackKey(key.data(), use + 1));
      if (it != table.end()) return backoff_sum + it->second.logprob;
      // not found: add the backoff of the context we are abandoning
      if (use > 0) {
        std::vector<WordId> ctx_key(ctx.end() - use, ctx.end());
        const auto& ctx_table = tables[use - 1];
        auto cit = ctx_table.find(PackKey(ctx_key.data(), use));
        if (cit != ctx_table.end()) backoff_sum += cit->second.backoff;
      }
    }
    // OOV: unigram table always has <unk>
    auto it = tables[0].find(PackKey(&unk, 1));
    return backoff_sum + (it != tables[0].end() ? it->second.logprob : -10.0f);
  }
};

// ---------------------------------------------------------------------------------
// Training
// ---------------------------------------------------------------------------------

struct Counts {
  // per order: key -> adjusted count
  std::vector<std::unordered_map<std::string, uint64_t>> grams;
};

static void SplitWhitespace(const std::string& line,
                            std::vector<std::string>* out) {
  out->clear();
  std::istringstream ss(line);
  std::string tok;
  while (ss >> tok) out->push_back(tok);
}

// Discounts per (order, count-bucket 1/2/3+), from counts-of-counts.
struct Discounts {
  double d[4] = {0, 0.5, 1.0, 1.5};  // d[c] for c = 1, 2, 3+ (index by min(c,3))
  double For(uint64_t c) const { return d[std::min<uint64_t>(c, 3)]; }
};

static Discounts DiscountsFromCoC(const uint64_t n[5]) {
  Discounts out;
  if (n[1] == 0 || n[2] == 0) return out;  // fall back to defaults
  double y = static_cast<double>(n[1]) / (n[1] + 2.0 * n[2]);
  for (int i = 1; i <= 3; ++i) {
    if (n[i] == 0 || n[i + 1] == 0) continue;
    double d = i - (i + 1) * y * static_cast<double>(n[i + 1]) / n[i];
    if (d > 0 && d <= i) out.d[i] = d;
  }
  return out;
}

static Discounts EstimateDiscounts(
    const std::unordered_map<std::string, uint64_t>& grams) {
  uint64_t n[5] = {0, 0, 0, 0, 0};
  for (const auto& kv : grams) {
    if (kv.second >= 1 && kv.second <= 4) n[kv.second]++;
  }
  return DiscountsFromCoC(n);
}

static const float kLog10Min = -99.0f;

static int EmitArpa(const Model& model, const char* arpa_path) {
  int order = model.order;
  std::ofstream out(arpa_path);
  if (!out) return 2;
  out.precision(7);
  out << "\\data\\\n";
  for (int n = 1; n <= order; ++n)
    out << "ngram " << n << "=" << model.tables[n - 1].size() << "\n";
  out << "\n";
  for (int n = 1; n <= order; ++n) {
    out << "\\" << n << "-grams:\n";
    for (const auto& kv : model.tables[n - 1]) {
      const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
      out << kv.second.logprob;
      for (int i = 0; i < n; ++i) out << (i ? " " : "\t")
                                      << model.vocab.words[ids[i]];
      if (n < order && kv.second.backoff != 0.0f)
        out << "\t" << kv.second.backoff;
      out << "\n";
    }
    out << "\n";
  }
  out << "\\end\\\n";
  return 0;
}

int Train(const char* corpus_path, const char* arpa_path, int order,
          const std::vector<uint64_t>& prune) {
  std::ifstream in(corpus_path);
  if (!in) return 1;

  Model model;
  model.order = order;
  WordId bos = model.vocab.GetOrAdd(kBOS);
  WordId eos = model.vocab.GetOrAdd(kEOS);
  WordId unk = model.vocab.GetOrAdd(kUNK);
  model.bos = bos;
  model.eos = eos;
  model.unk = unk;

  // ---- raw counts ---------------------------------------------------------------
  Counts counts;
  counts.grams.resize(order);
  {
    std::string line;
    std::vector<std::string> toks;
    std::vector<WordId> sent;
    while (std::getline(in, line)) {
      SplitWhitespace(line, &toks);
      if (toks.empty()) continue;
      sent.clear();
      sent.push_back(bos);
      for (const auto& t : toks) sent.push_back(model.vocab.GetOrAdd(t));
      sent.push_back(eos);
      int len = static_cast<int>(sent.size());
      // Count n-grams ending at every position >= 1 (<s> never predicted).
      for (int end = 1; end < len; ++end) {
        for (int n = 1; n <= order; ++n) {
          int start = end - n + 1;
          if (start < 0) break;
          counts.grams[n - 1][PackKey(&sent[start], n)]++;
        }
      }
      // Plus pure-context n-grams starting with <s> (needed for denominators).
    }
  }

  // ---- adjusted counts (continuation) for orders < N -----------------------------
  // adjusted(w_1..w_n) = |{v : c(v, w_1..w_n) > 0}| unless w_1 == <s>.
  for (int n = order - 1; n >= 1; --n) {
    std::unordered_map<std::string, uint64_t> adjusted;
    adjusted.reserve(counts.grams[n - 1].size());
    for (const auto& kv : counts.grams[n]) {
      // kv is an (n+1)-gram v, w_1..w_n -> continuation of its suffix
      const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
      adjusted[PackKey(ids + 1, n)]++;
    }
    // <s>-initial n-grams keep raw counts (cannot be extended left).
    for (auto& kv : counts.grams[n - 1]) {
      const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
      if (ids[0] == bos) continue;
      auto it = adjusted.find(kv.first);
      kv.second = (it == adjusted.end()) ? 0 : it->second;
    }
    // Drop zero-adjusted entries (unseen as continuations).
    for (auto it = counts.grams[n - 1].begin();
         it != counts.grams[n - 1].end();) {
      if (it->second == 0) it = counts.grams[n - 1].erase(it);
      else ++it;
    }
  }

  // ---- discounts -----------------------------------------------------------------
  std::vector<Discounts> discounts(order);
  for (int n = 1; n <= order; ++n)
    discounts[n - 1] = EstimateDiscounts(counts.grams[n - 1]);

  // ---- survivor sets (pruning with the ARPA context constraint) -------------------
  // An n-gram survives if its count exceeds the threshold OR it is the context
  // (prefix) of a surviving (n+1)-gram — a valid ARPA model must contain every
  // context of every entry, else pruned contexts would shadow the backoff path.
  std::vector<std::unordered_map<std::string, bool>> keep(order);
  for (int n = order; n >= 1; --n) {
    uint64_t threshold =
        (static_cast<int>(prune.size()) >= n) ? prune[n - 1] : 0;
    for (const auto& kv : counts.grams[n - 1]) {
      if (threshold == 0 || kv.second > threshold) keep[n - 1][kv.first] = true;
    }
    if (n >= 2) {
      for (const auto& kv : keep[n - 1]) {
        keep[n - 2][kv.first.substr(0, (n - 1) * sizeof(WordId))] = true;
      }
    }
  }

  // ---- probabilities bottom-up ----------------------------------------------------
  model.tables.resize(order);

  // Unigrams: interpolate with uniform over the vocabulary.
  {
    const auto& grams = counts.grams[0];
    const Discounts& dc = discounts[0];
    double total = 0;
    uint64_t n1 = 0, n2 = 0, n3p = 0;
    for (const auto& kv : grams) {
      total += static_cast<double>(kv.second);
      if (kv.second == 1) n1++;
      else if (kv.second == 2) n2++;
      else n3p++;
    }
    // Uniform base distribution over predictable words (<s> is never
    // predicted, so it is excluded — keeps the unigram distribution normalised).
    double vocab_size = static_cast<double>(model.vocab.words.size()) - 1.0;
    double gamma =
        (dc.d[1] * n1 + dc.d[2] * n2 + dc.d[3] * n3p) / std::max(total, 1.0);
    double uniform = 1.0 / std::max(vocab_size, 1.0);
    for (const auto& kv : grams) {
      const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
      double p = (kv.second - dc.For(kv.second)) / std::max(total, 1.0) +
                 gamma * uniform;
      Entry e;
      e.logprob = (ids[0] == bos)
                      ? kLog10Min  // <s> is never predicted
                      : static_cast<float>(std::log10(std::max(p, 1e-12)));
      model.tables[0][kv.first] = e;
    }
    // <unk>: leftover uniform mass.
    Entry ue;
    ue.logprob = static_cast<float>(
        std::log10(std::max(gamma * uniform, 1e-12)));
    auto it = model.tables[0].find(PackKey(&unk, 1));
    if (it == model.tables[0].end()) model.tables[0][PackKey(&unk, 1)] = ue;
    // Ensure <s> exists even if the corpus was empty.
    if (!model.tables[0].count(PackKey(&bos, 1))) {
      Entry be;
      be.logprob = kLog10Min;
      model.tables[0][PackKey(&bos, 1)] = be;
    }
  }

  // Higher orders.
  for (int n = 2; n <= order; ++n) {
    const auto& grams = counts.grams[n - 1];
    const Discounts& dc = discounts[n - 1];
    uint64_t threshold =
        (static_cast<int>(prune.size()) >= n) ? prune[n - 1] : 0;

    // Context statistics: denominator and N1/N2/N3+ per context.
    struct CtxStat {
      double denom = 0;
      uint64_t n1 = 0, n2 = 0, n3p = 0;
      double sum_p = 0;        // surviving interpolated prob mass
      double sum_p_lower = 0;  // lower-order mass of the surviving extensions
    };
    std::unordered_map<std::string, CtxStat> ctx_stats;
    for (const auto& kv : grams) {
      std::string ctx = kv.first.substr(0, (n - 1) * sizeof(WordId));
      auto& st = ctx_stats[ctx];
      st.denom += static_cast<double>(kv.second);
      if (kv.second == 1) st.n1++;
      else if (kv.second == 2) st.n2++;
      else st.n3p++;
    }

    // Probabilities for surviving entries.
    for (const auto& kv : grams) {
      if (!keep[n - 1].count(kv.first)) continue;
      const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
      std::string ctx = kv.first.substr(0, (n - 1) * sizeof(WordId));
      auto& st = ctx_stats[ctx];
      double gamma = (dc.d[1] * st.n1 + dc.d[2] * st.n2 + dc.d[3] * st.n3p) /
                     std::max(st.denom, 1.0);
      std::vector<WordId> lower_ctx(ids + 1, ids + n - 1);
      double p_lower =
          std::pow(10.0, model.Score(lower_ctx, ids[n - 1]));
      double p = (kv.second - dc.For(kv.second)) / std::max(st.denom, 1.0);
      p = std::max(p, 0.0) + gamma * p_lower;
      p = std::min(std::max(p, 1e-12), 1.0);
      Entry e;
      e.logprob = static_cast<float>(std::log10(p));
      model.tables[n - 1][kv.first] = e;
      st.sum_p += p;
      st.sum_p_lower += p_lower;
    }

    // Backoff weights live on the (n-1)-gram context entries. The exact ARPA
    // renormalisation b(ctx) = (1 - sum_surviving p) / (1 - sum_surviving
    // p_lower) keeps every context distribution summing to 1, pruning included.
    for (const auto& cs : ctx_stats) {
      const CtxStat& st = cs.second;
      if (st.sum_p == 0.0) continue;  // all extensions pruned: no backoff entry
      double num = std::max(1.0 - st.sum_p, 1e-12);
      double den = std::max(1.0 - st.sum_p_lower, 1e-12);
      double b = num / den;
      auto it = model.tables[n - 2].find(cs.first);
      // The context constraint in the survivor sets guarantees presence.
      if (it != model.tables[n - 2].end()) {
        it->second.backoff = static_cast<float>(std::log10(b));
      }
    }
  }

  return EmitArpa(model, arpa_path);
}

// ---------------------------------------------------------------------------------
// Streamed training (lmplz-style disk pipeline)
//
// The in-memory Train() holds every distinct n-gram in hash maps — fine for the
// reference's decoder corpora, but lmplz streams its counts through sorted disk
// shards so corpus size never bounds memory (reference invocation:
// src/coral/ngram.py:126-143). TrainStreamed() reproduces that design:
//
//   1. counting: per-order bounded hash maps spill sorted shards to a scratch
//      dir whenever they reach the entry budget; a k-way merge replays each
//      order as one sorted, aggregated stream;
//   2. adjusted (continuation) counts: the (n+1)-gram stream is re-sorted into
//      (suffix, head) order through another shard set, so distinct left
//      extensions per suffix are countable in one grouped pass, and merge-joined
//      with the raw order-n stream (<s>-initial n-grams keep raw counts);
//   3. discounts, survivor sets (pruning + the ARPA context constraint) and the
//      interpolated Kneser-Ney probabilities all run as merge-joins over the
//      sorted per-order files; sorted fixed-width keys make context groups
//      contiguous, so each group is buffered alone.
//
// Peak memory = the shard budget + one context group + the *pruned* model
// (which must fit for querying anyway). The resulting ARPA is entry-for-entry
// identical to the in-memory path (pinned by tests/test_decoding.py).
// ---------------------------------------------------------------------------------

namespace streamed {

// Pull-based sorted (key, count) stream; keys are fixed-width packed WordIds,
// compared bytewise (any consistent total order works for grouping/joins).
class KVStream {
 public:
  virtual ~KVStream() = default;
  virtual bool Next(std::string* key, uint64_t* count) = 0;
};

class FileStream : public KVStream {
 public:
  FileStream(const std::string& path, int key_bytes)
      : in_(path, std::ios::binary), key_bytes_(key_bytes) {}
  bool Next(std::string* key, uint64_t* count) override {
    key->resize(key_bytes_);
    if (!in_.read(&(*key)[0], key_bytes_)) return false;
    uint64_t c = 0;
    if (!in_.read(reinterpret_cast<char*>(&c), sizeof(c))) return false;
    *count = c;
    return true;
  }

 private:
  std::ifstream in_;
  int key_bytes_;
};

class FileWriter {
 public:
  explicit FileWriter(const std::string& path)
      : out_(path, std::ios::binary) {}
  void Put(const std::string& key, uint64_t c) {
    out_.write(key.data(), static_cast<std::streamsize>(key.size()));
    out_.write(reinterpret_cast<const char*>(&c), sizeof(c));
  }
  bool ok() const { return static_cast<bool>(out_); }

 private:
  std::ofstream out_;
};

// K-way merge over sorted shards, aggregating counts of equal keys. A linear
// scan over the heads is plenty: shard counts stay small (budget-sized spills).
class MergeStream : public KVStream {
 public:
  MergeStream(const std::vector<std::string>& paths, int key_bytes) {
    for (const auto& p : paths) {
      auto f = std::unique_ptr<FileStream>(new FileStream(p, key_bytes));
      std::string k;
      uint64_t c;
      if (f->Next(&k, &c)) {
        files_.push_back(std::move(f));
        keys_.push_back(std::move(k));
        counts_.push_back(c);
        alive_.push_back(true);
      }
    }
  }
  bool Next(std::string* key, uint64_t* count) override {
    int best = -1;
    for (size_t i = 0; i < files_.size(); ++i) {
      if (alive_[i] && (best < 0 || keys_[i] < keys_[best]))
        best = static_cast<int>(i);
    }
    if (best < 0) return false;
    *key = keys_[best];
    *count = 0;
    for (size_t i = 0; i < files_.size(); ++i) {
      while (alive_[i] && keys_[i] == *key) {
        *count += counts_[i];
        alive_[i] = files_[i]->Next(&keys_[i], &counts_[i]);
      }
    }
    return true;
  }

 private:
  std::vector<std::unique_ptr<FileStream>> files_;
  std::vector<std::string> keys_;
  std::vector<uint64_t> counts_;
  std::vector<bool> alive_;
};

// Bounded hash map spilling sorted shards once the entry budget is reached.
class ShardSet {
 public:
  ShardSet(std::string dir, std::string tag, int key_bytes, size_t budget)
      : dir_(std::move(dir)), tag_(std::move(tag)), key_bytes_(key_bytes),
        budget_(std::max<size_t>(budget, 64)) {}

  void Add(const std::string& key, uint64_t c) {
    auto it = map_.find(key);
    if (it != map_.end()) {
      it->second += c;
      return;
    }
    map_.emplace(key, c);
    if (map_.size() >= budget_) Flush();
  }

  std::unique_ptr<KVStream> Stream() {
    Flush();
    return std::unique_ptr<KVStream>(new MergeStream(paths_, key_bytes_));
  }

 private:
  void Flush() {
    if (map_.empty()) return;
    std::vector<std::pair<std::string, uint64_t>> recs(map_.begin(),
                                                       map_.end());
    std::sort(recs.begin(), recs.end());
    std::string path =
        dir_ + "/" + tag_ + "." + std::to_string(paths_.size());
    FileWriter w(path);
    for (const auto& kv : recs) w.Put(kv.first, kv.second);
    paths_.push_back(path);
    map_.clear();
  }

  std::string dir_, tag_;
  int key_bytes_;
  size_t budget_;
  std::unordered_map<std::string, uint64_t> map_;
  std::vector<std::string> paths_;
};

}  // namespace streamed

int TrainStreamed(const char* corpus_path, const char* arpa_path, int order,
                  const std::vector<uint64_t>& prune, size_t budget_entries,
                  const char* scratch_dir) {
  using streamed::FileStream;
  using streamed::FileWriter;
  using streamed::ShardSet;
  const int W = static_cast<int>(sizeof(WordId));

  std::ifstream in(corpus_path);
  if (!in) return 1;

  std::string base =
      (scratch_dir && *scratch_dir) ? scratch_dir : "/tmp";
  std::string templ = base + "/coral_lm_XXXXXX";
  std::vector<char> dbuf(templ.begin(), templ.end());
  dbuf.push_back('\0');
  if (mkdtemp(dbuf.data()) == nullptr) return 3;
  std::string tmp(dbuf.data());
  auto cleanup = [&tmp]() {
    std::error_code ec;
    std::filesystem::remove_all(tmp, ec);
  };

  Model model;
  model.order = order;
  WordId bos = model.vocab.GetOrAdd(kBOS);
  WordId eos = model.vocab.GetOrAdd(kEOS);
  WordId unk = model.vocab.GetOrAdd(kUNK);
  model.bos = bos;
  model.eos = eos;
  model.unk = unk;

  size_t per_order = std::max<size_t>(budget_entries / (order + 1), 1024);

  // ---- pass 1: raw counts into per-order shard sets -------------------------------
  std::vector<std::unique_ptr<ShardSet>> raw;
  for (int n = 1; n <= order; ++n) {
    raw.emplace_back(new ShardSet(tmp, "raw" + std::to_string(n), n * W,
                                  per_order));
  }
  {
    std::string line;
    std::vector<std::string> toks;
    std::vector<WordId> sent;
    while (std::getline(in, line)) {
      SplitWhitespace(line, &toks);
      if (toks.empty()) continue;
      sent.clear();
      sent.push_back(bos);
      for (const auto& t : toks) sent.push_back(model.vocab.GetOrAdd(t));
      sent.push_back(eos);
      int len = static_cast<int>(sent.size());
      for (int end = 1; end < len; ++end) {
        for (int n = 1; n <= order; ++n) {
          int start = end - n + 1;
          if (start < 0) break;
          raw[n - 1]->Add(PackKey(&sent[start], n), 1);
        }
      }
    }
  }

  // ---- per-order final sorted count files -----------------------------------------
  // finals[o-1]: one sorted (key, count) file per order, top order = raw
  // counts, lower orders = adjusted continuation counts.
  std::vector<std::string> finals(order);
  {
    finals[order - 1] = tmp + "/final" + std::to_string(order);
    auto s = raw[order - 1]->Stream();
    FileWriter w(finals[order - 1]);
    std::string k;
    uint64_t c;
    while (s->Next(&k, &c)) w.Put(k, c);
  }
  for (int n = order - 1; n >= 1; --n) {
    // Re-sort the (n+1)-grams into (suffix, head) order.
    ShardSet rot(tmp, "rot" + std::to_string(n), (n + 1) * W, per_order);
    {
      FileStream hi(finals[n], (n + 1) * W);
      std::string k;
      uint64_t c;
      while (hi.Next(&k, &c)) {
        const WordId* ids = reinterpret_cast<const WordId*>(k.data());
        rot.Add(PackKey(ids + 1, n) + PackKey(ids, 1), 1);
      }
    }
    auto rs = rot.Stream();
    std::string rk;
    uint64_t rc = 0;
    bool rok = rs->Next(&rk, &rc);
    // Grouped pass: distinct heads per suffix = the adjusted count.
    auto next_adjusted = [&](std::string* akey, uint64_t* acount) -> bool {
      if (!rok) return false;
      *akey = rk.substr(0, n * W);
      *acount = 0;
      while (rok && rk.compare(0, n * W, *akey) == 0) {
        ++(*acount);
        rok = rs->Next(&rk, &rc);
      }
      return true;
    };
    finals[n - 1] = tmp + "/final" + std::to_string(n);
    FileWriter w(finals[n - 1]);
    auto raw_s = raw[n - 1]->Stream();
    std::string ak;
    uint64_t ac = 0;
    bool aok = next_adjusted(&ak, &ac);
    std::string gk;
    uint64_t gc;
    while (raw_s->Next(&gk, &gc)) {
      while (aok && ak < gk) aok = next_adjusted(&ak, &ac);
      const WordId* ids = reinterpret_cast<const WordId*>(gk.data());
      if (ids[0] == bos) {
        // <s>-initial n-grams keep raw counts (cannot be extended left).
        w.Put(gk, gc);
      } else if (aok && ak == gk) {
        w.Put(gk, ac);
      }
      // else: never seen as a continuation — dropped, as in Train().
    }
  }

  // ---- discounts from streamed counts-of-counts -----------------------------------
  std::vector<Discounts> discounts(order);
  for (int n = 1; n <= order; ++n) {
    uint64_t coc[5] = {0, 0, 0, 0, 0};
    FileStream s(finals[n - 1], n * W);
    std::string k;
    uint64_t c;
    while (s.Next(&k, &c)) {
      if (c >= 1 && c <= 4) coc[c]++;
    }
    discounts[n - 1] = DiscountsFromCoC(coc);
  }

  // ---- survivor sets, top-down (pruning + ARPA context constraint) ----------------
  std::vector<std::string> surv(order);
  std::string ctx_path;
  for (int n = order; n >= 1; --n) {
    uint64_t threshold =
        (static_cast<int>(prune.size()) >= n) ? prune[n - 1] : 0;
    surv[n - 1] = tmp + "/surv" + std::to_string(n);
    FileWriter sw(surv[n - 1]);
    std::unique_ptr<FileWriter> cw;
    std::string next_ctx = tmp + "/ctx" + std::to_string(n - 1);
    if (n >= 2) cw.reset(new FileWriter(next_ctx));
    FileStream counts(finals[n - 1], n * W);
    std::unique_ptr<FileStream> ctxs;
    if (!ctx_path.empty()) ctxs.reset(new FileStream(ctx_path, n * W));
    std::string ck;
    uint64_t cc = 0;
    bool cok = ctxs && ctxs->Next(&ck, &cc);
    std::string k;
    uint64_t c;
    std::string last_prefix;
    while (counts.Next(&k, &c)) {
      while (cok && ck < k) cok = ctxs->Next(&ck, &cc);
      bool kept = (threshold == 0 || c > threshold) || (cok && ck == k);
      if (!kept) continue;
      sw.Put(k, 1);
      if (n >= 2) {
        // Prefixes of a sorted stream arrive sorted; dedupe adjacent runs.
        std::string prefix = k.substr(0, (n - 1) * W);
        if (prefix != last_prefix) {
          cw->Put(prefix, 1);
          last_prefix = prefix;
        }
      }
    }
    ctx_path = next_ctx;
  }

  // ---- probabilities bottom-up ----------------------------------------------------
  model.tables.resize(order);
  {
    // Unigrams: totals pass, then insertion (all unigram entries, as Train()).
    const Discounts& dc = discounts[0];
    double total = 0;
    uint64_t n1 = 0, n2 = 0, n3p = 0;
    {
      FileStream s(finals[0], W);
      std::string k;
      uint64_t c;
      while (s.Next(&k, &c)) {
        total += static_cast<double>(c);
        if (c == 1) n1++;
        else if (c == 2) n2++;
        else n3p++;
      }
    }
    double vocab_size = static_cast<double>(model.vocab.words.size()) - 1.0;
    double gamma =
        (dc.d[1] * n1 + dc.d[2] * n2 + dc.d[3] * n3p) / std::max(total, 1.0);
    double uniform = 1.0 / std::max(vocab_size, 1.0);
    FileStream s(finals[0], W);
    std::string k;
    uint64_t c;
    while (s.Next(&k, &c)) {
      const WordId* ids = reinterpret_cast<const WordId*>(k.data());
      double p = (c - dc.For(c)) / std::max(total, 1.0) + gamma * uniform;
      Entry e;
      e.logprob = (ids[0] == bos)
                      ? kLog10Min
                      : static_cast<float>(std::log10(std::max(p, 1e-12)));
      model.tables[0][k] = e;
    }
    Entry ue;
    ue.logprob =
        static_cast<float>(std::log10(std::max(gamma * uniform, 1e-12)));
    if (!model.tables[0].count(PackKey(&unk, 1)))
      model.tables[0][PackKey(&unk, 1)] = ue;
    if (!model.tables[0].count(PackKey(&bos, 1))) {
      Entry be;
      be.logprob = kLog10Min;
      model.tables[0][PackKey(&bos, 1)] = be;
    }
  }

  for (int n = 2; n <= order; ++n) {
    const Discounts& dc = discounts[n - 1];
    FileStream counts(finals[n - 1], n * W);
    FileStream svs(surv[n - 1], n * W);
    std::string sk;
    uint64_t s_unused = 0;
    bool sok = svs.Next(&sk, &s_unused);

    std::string k;
    uint64_t c;
    bool ok = counts.Next(&k, &c);
    std::vector<std::pair<std::string, uint64_t>> group;
    while (ok) {
      std::string ctx = k.substr(0, (n - 1) * W);
      group.clear();
      while (ok && k.compare(0, (n - 1) * W, ctx) == 0) {
        group.emplace_back(k, c);
        ok = counts.Next(&k, &c);
      }
      double denom = 0;
      uint64_t g1 = 0, g2 = 0, g3p = 0;
      for (const auto& kv : group) {
        denom += static_cast<double>(kv.second);
        if (kv.second == 1) g1++;
        else if (kv.second == 2) g2++;
        else g3p++;
      }
      double gamma = (dc.d[1] * g1 + dc.d[2] * g2 + dc.d[3] * g3p) /
                     std::max(denom, 1.0);
      double sum_p = 0, sum_p_lower = 0;
      for (const auto& kv : group) {
        while (sok && sk < kv.first) sok = svs.Next(&sk, &s_unused);
        if (!(sok && sk == kv.first)) continue;
        const WordId* ids = reinterpret_cast<const WordId*>(kv.first.data());
        std::vector<WordId> lower_ctx(ids + 1, ids + n - 1);
        double p_lower = std::pow(10.0, model.Score(lower_ctx, ids[n - 1]));
        double p =
            (kv.second - dc.For(kv.second)) / std::max(denom, 1.0);
        p = std::max(p, 0.0) + gamma * p_lower;
        p = std::min(std::max(p, 1e-12), 1.0);
        Entry e;
        e.logprob = static_cast<float>(std::log10(p));
        model.tables[n - 1][kv.first] = e;
        sum_p += p;
        sum_p_lower += p_lower;
      }
      if (sum_p != 0.0) {
        double num = std::max(1.0 - sum_p, 1e-12);
        double den = std::max(1.0 - sum_p_lower, 1e-12);
        auto it = model.tables[n - 2].find(ctx);
        if (it != model.tables[n - 2].end())
          it->second.backoff = static_cast<float>(std::log10(num / den));
      }
    }
  }

  int rc = EmitArpa(model, arpa_path);
  cleanup();
  return rc;
}

// ---------------------------------------------------------------------------------
// ARPA loading
// ---------------------------------------------------------------------------------

Model* LoadArpa(const char* path) {
  std::ifstream in(path);
  if (!in) return nullptr;
  auto model = new Model();
  std::string line;
  int current_order = 0;
  std::vector<std::string> toks;
  while (std::getline(in, line)) {
    if (line.empty() || line[0] == '\\') {
      if (line.rfind("\\end", 0) == 0) break;
      if (line.size() > 2 && line[1] >= '1' && line[1] <= '9' &&
          line.find("-grams:") != std::string::npos) {
        current_order = line[1] - '0';
        if (static_cast<int>(model->tables.size()) < current_order)
          model->tables.resize(current_order);
        model->order = std::max(model->order, current_order);
      }
      continue;
    }
    if (current_order == 0) continue;
    SplitWhitespace(line, &toks);
    if (static_cast<int>(toks.size()) < current_order + 1) continue;
    Entry e;
    e.logprob = std::strtof(toks[0].c_str(), nullptr);
    bool has_backoff =
        static_cast<int>(toks.size()) == current_order + 2;
    if (has_backoff)
      e.backoff = std::strtof(toks.back().c_str(), nullptr);
    std::vector<WordId> ids;
    ids.reserve(current_order);
    for (int i = 1; i <= current_order; ++i)
      ids.push_back(model->vocab.GetOrAdd(toks[i]));
    model->tables[current_order - 1][PackKey(ids.data(), current_order)] = e;
  }
  model->order = static_cast<int>(model->tables.size());
  int bos = model->vocab.Find(kBOS);
  int eos = model->vocab.Find(kEOS);
  int unk = model->vocab.Find(kUNK);
  model->bos = bos >= 0 ? bos : model->vocab.GetOrAdd(kBOS);
  model->eos = eos >= 0 ? eos : model->vocab.GetOrAdd(kEOS);
  model->unk = unk >= 0 ? unk : model->vocab.GetOrAdd(kUNK);
  return model;
}

}  // namespace coral

// ---------------------------------------------------------------------------------
// C ABI (ctypes)
// ---------------------------------------------------------------------------------

extern "C" {

int coral_ngram_train(const char* corpus_path, const char* arpa_path, int order,
                      const uint64_t* prune, int prune_len) {
  std::vector<uint64_t> p(prune, prune + prune_len);
  return coral::Train(corpus_path, arpa_path, order, p);
}

// Disk-streamed estimation (lmplz pipeline): in-memory footprint bounded by
// `budget_entries` hash-map entries (spilled to sorted shards under
// `scratch_dir`, default /tmp) plus the final pruned model.
int coral_ngram_train_streamed(const char* corpus_path, const char* arpa_path,
                               int order, const uint64_t* prune, int prune_len,
                               uint64_t budget_entries,
                               const char* scratch_dir) {
  std::vector<uint64_t> p(prune, prune + prune_len);
  return coral::TrainStreamed(corpus_path, arpa_path, order, p,
                              static_cast<size_t>(budget_entries),
                              scratch_dir);
}

void* coral_ngram_load(const char* arpa_path) {
  return coral::LoadArpa(arpa_path);
}

void coral_ngram_free(void* handle) {
  delete static_cast<coral::Model*>(handle);
}

int coral_ngram_order(void* handle) {
  return static_cast<coral::Model*>(handle)->order;
}

// log10 p(word | space-separated context words). Unknown words -> <unk>.
float coral_ngram_logprob(void* handle, const char* context, const char* word) {
  auto* model = static_cast<coral::Model*>(handle);
  std::vector<coral::WordId> ctx;
  std::vector<std::string> toks;
  coral::SplitWhitespace(context, &toks);
  for (const auto& t : toks) {
    int id = model->vocab.Find(t);
    ctx.push_back(id >= 0 ? static_cast<coral::WordId>(id) : model->unk);
  }
  int wid = model->vocab.Find(word);
  return model->Score(
      ctx, wid >= 0 ? static_cast<coral::WordId>(wid) : model->unk);
}

// log10 probability of a full sentence (with implicit <s> ... </s>).
float coral_ngram_sentence_logprob(void* handle, const char* sentence) {
  auto* model = static_cast<coral::Model*>(handle);
  std::vector<std::string> toks;
  coral::SplitWhitespace(sentence, &toks);
  std::vector<coral::WordId> ctx = {model->bos};
  float total = 0.0f;
  for (const auto& t : toks) {
    int id = model->vocab.Find(t);
    coral::WordId wid =
        id >= 0 ? static_cast<coral::WordId>(id) : model->unk;
    total += model->Score(ctx, wid);
    ctx.push_back(wid);
  }
  total += model->Score(ctx, model->eos);
  return total;
}

}  // extern "C"

// ---------------------------------------------------------------------------------
// Binary serialisation (the `build_binary` role: fast mmap-free load, compact file)
// ---------------------------------------------------------------------------------

namespace coral {

static const uint32_t kBinaryMagic = 0x434f4c4d;  // "COLM"
static const uint32_t kBinaryVersion = 1;

int SaveBinary(const Model& model, const char* path) {
  FILE* f = std::fopen(path, "wb");
  if (!f) return 1;
  auto w32 = [&](uint32_t v) { std::fwrite(&v, 4, 1, f); };
  w32(kBinaryMagic);
  w32(kBinaryVersion);
  w32(static_cast<uint32_t>(model.order));
  w32(static_cast<uint32_t>(model.vocab.words.size()));
  for (const auto& word : model.vocab.words) {
    w32(static_cast<uint32_t>(word.size()));
    std::fwrite(word.data(), 1, word.size(), f);
  }
  for (int n = 1; n <= model.order; ++n) {
    const auto& table = model.tables[n - 1];
    w32(static_cast<uint32_t>(table.size()));
    for (const auto& kv : table) {
      std::fwrite(kv.first.data(), 1, n * sizeof(WordId), f);
      std::fwrite(&kv.second.logprob, 4, 1, f);
      std::fwrite(&kv.second.backoff, 4, 1, f);
    }
  }
  std::fclose(f);
  return 0;
}

Model* LoadBinary(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  auto r32 = [&]() -> uint32_t {
    uint32_t v = 0;
    if (std::fread(&v, 4, 1, f) != 1) return 0;
    return v;
  };
  if (r32() != kBinaryMagic || r32() != kBinaryVersion) {
    std::fclose(f);
    return nullptr;
  }
  auto model = new Model();
  model->order = static_cast<int>(r32());
  uint32_t vocab_size = r32();
  model->vocab.words.reserve(vocab_size);
  std::string buf;
  for (uint32_t i = 0; i < vocab_size; ++i) {
    uint32_t len = r32();
    buf.resize(len);
    if (len && std::fread(&buf[0], 1, len, f) != len) {
      std::fclose(f);
      delete model;
      return nullptr;
    }
    model->vocab.ids.emplace(buf, i);
    model->vocab.words.push_back(buf);
  }
  model->tables.resize(model->order);
  std::string key;
  for (int n = 1; n <= model->order; ++n) {
    uint32_t count = r32();
    auto& table = model->tables[n - 1];
    table.reserve(count);
    key.resize(n * sizeof(WordId));
    for (uint32_t i = 0; i < count; ++i) {
      Entry e;
      if (std::fread(&key[0], 1, key.size(), f) != key.size() ||
          std::fread(&e.logprob, 4, 1, f) != 1 ||
          std::fread(&e.backoff, 4, 1, f) != 1) {
        std::fclose(f);
        delete model;
        return nullptr;
      }
      table.emplace(key, e);
    }
  }
  std::fclose(f);
  int bos = model->vocab.Find(kBOS);
  int eos = model->vocab.Find(kEOS);
  int unk = model->vocab.Find(kUNK);
  model->bos = bos >= 0 ? bos : model->vocab.GetOrAdd(kBOS);
  model->eos = eos >= 0 ? eos : model->vocab.GetOrAdd(kEOS);
  model->unk = unk >= 0 ? unk : model->vocab.GetOrAdd(kUNK);
  return model;
}

}  // namespace coral

extern "C" {

// Serialise a loaded model to the compact binary format (`build_binary` role).
int coral_ngram_save_binary(void* handle, const char* path) {
  return coral::SaveBinary(*static_cast<coral::Model*>(handle), path);
}

// Load either format: binary (magic-sniffed) or ARPA text.
void* coral_ngram_load_any(const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return nullptr;
  uint32_t magic = 0;
  size_t n = std::fread(&magic, 4, 1, f);
  std::fclose(f);
  if (n == 1 && magic == coral::kBinaryMagic) return coral::LoadBinary(path);
  return coral::LoadArpa(path);
}

}  // extern "C"
