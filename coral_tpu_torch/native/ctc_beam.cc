// CTC beam search with n-gram shallow fusion, pyctcdecode-parity semantics.
//
// Native replacement for the reference's pyctcdecode dependency (reference:
// src/coral/ngram.py:341-353 `build_ctcdecoder`, and
// src/coral/compute_metrics.py:53-54 `Wav2Vec2ProcessorWithLM.batch_decode`).
// The device produces per-frame log-probabilities; this host-side decoder
// follows pyctcdecode's algorithm:
//
//   - beams carry (completed text, in-progress word_part, last char); beams
//     with identical composition are merged by log-sum-exp of the acoustic
//     score;
//   - per frame, only tokens with log p >= token_min_logp (plus the argmax
//     token) are considered;
//   - the LM is applied *inside* the frame loop: ranking uses
//       logit_score
//         + sum over completed words of (alpha * ln10 * log10 P_lm + beta)
//         + partial_word_penalty(word_part),
//     so LM evidence and partial-word validity steer pruning mid-beam, not
//     only at word boundaries;
//   - partial_word_penalty matches pyctcdecode's unigram char-trie rule:
//     0 when word_part is a prefix of (or equal to) a known unigram, else
//     unk_score_offset, scaled by len/6 when len > 6. Without unigrams the
//     penalty is identically 0 — which is exactly the configuration the
//     reference ships (build_ctcdecoder without unigrams);
//   - score_boundary semantics: the first word is scored in the <s> context
//     and finalisation adds log10 P(</s> | context);
//   - beams below (best - beam_prune_logp) are dropped each frame, then the
//     top beam_width survive;
//   - finalisation merges beams by (text, trailing word) — last_char is
//     dropped, acoustic scores log-sum-exp — then scores the trailing
//     partial word as a full word (pyctcdecode `_merge_beams` + the
//     `is_eos` `_get_lm_beams` pass);
//   - pyctcdecode's per-text LM cache is reproduced at finalisation: </s>
//     (under score_boundary) is only added for final texts that were never
//     LM-scored mid-beam (a transcript ending exactly on a word boundary
//     hits the cache and skips </s>; a trailing partial whose merged text
//     some other path had already completed does too), and a finalisation
//     entry — cached *with* </s> — is consulted by later beams sharing the
//     same final text;
//   - hotwords follow pyctcdecode's HotwordScorer: +hotword_weight per
//     completed hotword, and in-progress words that are a prefix of some
//     hotword earn the character-prorated bonus
//     weight * len(part) / len(shortest hotword with that prefix)
//     (codepoint lengths) in place of the LM partial penalty.
//
// Exposed through the same C ABI shared library as the LM (ctypes; no
// pybind11 in this image).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <set>
#include <sstream>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <vector>

namespace coral {

// log(a + b) for log-domain a, b (natural log).
static inline double LogAdd(double a, double b) {
  if (a == -INFINITY) return b;
  if (b == -INFINITY) return a;
  double hi = std::max(a, b), lo = std::min(a, b);
  return hi + std::log1p(std::exp(lo - hi));
}

static const double kNegInf = -INFINITY;
static const double kAvgTokenLen = 6.0;  // pyctcdecode AVG_TOKEN_LEN

struct Beam {
  std::string text;       // completed words, space-joined
  std::string word_part;  // word in progress (since the last separator)
  int last_char = -1;     // last token id; -1 after a blank
  double logit_score = kNegInf;  // natural-log acoustic score (merged)
  double lm_score = 0.0;  // weighted LM of completed words (incl. hotwords)
};

}  // namespace coral

// LM query hook implemented in ngram.cc (log10 probability).
extern "C" float coral_ngram_logprob(void* handle, const char* context,
                                     const char* word);

namespace coral {

struct DecodeOptions {
  int beam_width = 100;
  float alpha = 0.5f;
  float beta = 1.5f;
  int lm_order = 3;
  bool score_boundary = true;
  double beam_prune_logp = -10.0;
  double token_min_logp = -5.0;
  double unk_score_offset = -10.0;
  float hotword_weight = 10.0f;
  const std::set<std::string>* unigrams = nullptr;  // sorted by std::set
  const std::set<std::string>* hotwords = nullptr;
};

// Codepoint count of a UTF-8 string (Python len(); the hotword proration is
// defined on characters, and Danish hotwords carry multibyte æ/ø/å).
static size_t Utf8Len(const std::string& s) {
  size_t n = 0;
  for (unsigned char c : s) {
    if ((c & 0xC0) != 0x80) ++n;
  }
  return n;
}

// pyctcdecode score_partial_token: 0 when the partial word is a prefix of a
// known unigram; otherwise the unk offset, scaled for overlong tokens.
static double PartialWordPenalty(const std::string& part,
                                 const DecodeOptions& opt) {
  if (part.empty() || opt.unigrams == nullptr) return 0.0;
  auto it = opt.unigrams->lower_bound(part);
  bool known = it != opt.unigrams->end() &&
               it->compare(0, part.size(), part) == 0;
  if (known) return 0.0;
  double penalty = opt.unk_score_offset;
  if (part.size() > kAvgTokenLen) {
    penalty *= static_cast<double>(part.size()) / kAvgTokenLen;
  }
  return penalty;
}

// In-progress-word score used for mid-beam ranking. When the partial is a
// prefix of some hotword, pyctcdecode's HotwordScorer.score_partial_token
// takes over from the LM partial penalty: weight * len(part) / len(shortest
// hotword with that prefix), lengths in codepoints.
static double PartialScore(const std::string& part, const DecodeOptions& opt) {
  if (part.empty()) return 0.0;
  if (opt.hotwords != nullptr) {
    size_t min_len = SIZE_MAX;
    for (auto it = opt.hotwords->lower_bound(part);
         it != opt.hotwords->end() &&
         it->compare(0, part.size(), part) == 0;
         ++it) {
      min_len = std::min(min_len, Utf8Len(*it));
    }
    if (min_len != SIZE_MAX) {
      return opt.hotword_weight * static_cast<double>(Utf8Len(part)) /
             static_cast<double>(min_len);
    }
  }
  return PartialWordPenalty(part, opt);
}

// LM context for the next word: the last (order-1) items of [<s>] + words.
static std::string LmContext(const std::string& text,
                             const DecodeOptions& opt) {
  std::vector<std::string> words;
  if (opt.score_boundary) words.push_back("<s>");
  std::istringstream iss(text);
  std::string w;
  while (iss >> w) words.push_back(w);
  int start = std::max(0, static_cast<int>(words.size()) - (opt.lm_order - 1));
  std::string out;
  for (size_t i = start; i < words.size(); ++i) {
    if (!out.empty()) out += ' ';
    out += words[i];
  }
  return out;
}

// Weighted score for completing `word` after `text` (pyctcdecode
// LanguageModel.score): alpha * ln10 * log10 P(word | ctx) + beta, plus the
// whole-word hotword boost.
static double ScoreWord(void* lm, const std::string& text,
                        const std::string& word, const DecodeOptions& opt) {
  static const double kLn10 = std::log(10.0);
  double out = 0.0;
  if (lm != nullptr) {
    std::string ctx = LmContext(text, opt);
    float lp10 = coral_ngram_logprob(lm, ctx.c_str(), word.c_str());
    out += opt.alpha * lp10 * kLn10 + opt.beta;
  }
  if (opt.hotwords != nullptr && opt.hotwords->count(word)) {
    out += opt.hotword_weight;
  }
  return out;
}

// log10 P(</s> | context after all words) under score_boundary.
static double ScoreEos(void* lm, const std::string& full_text,
                       const DecodeOptions& opt) {
  static const double kLn10 = std::log(10.0);
  if (lm == nullptr || !opt.score_boundary) return 0.0;
  std::string ctx = LmContext(full_text, opt);
  float lp10 = coral_ngram_logprob(lm, ctx.c_str(), "</s>");
  return opt.alpha * lp10 * kLn10;
}

static std::string MergeText(const std::string& text,
                             const std::string& part) {
  if (part.empty()) return text;
  if (text.empty()) return part;
  return text + ' ' + part;
}

char* DecodeImpl(const float* log_probs, int T, int V, const char** vocab,
                 int blank_id, int word_sep_id, void* lm,
                 const DecodeOptions& opt) {
  std::vector<Beam> beams(1);
  beams[0].logit_score = 0.0;  // empty prefix, log 1

  // pyctcdecode's per-text LM cache, reduced to what finalisation needs:
  // which texts were scored, and whether their cached entry includes </s>
  // (mid-beam entries never do; finalisation entries always do).
  std::unordered_map<std::string, bool> lm_cache_has_eos;
  lm_cache_has_eos.emplace("", false);  // cache starts with the empty prefix

  std::vector<Beam> next;
  next.reserve(opt.beam_width * 8);
  std::vector<int> candidates;
  candidates.reserve(V);

  for (int t = 0; t < T; ++t) {
    const float* frame = log_probs + static_cast<int64_t>(t) * V;

    // pyctcdecode: tokens above token_min_logp, argmax always included.
    candidates.clear();
    int arg_max = 0;
    for (int v = 1; v < V; ++v) {
      if (frame[v] > frame[arg_max]) arg_max = v;
    }
    for (int v = 0; v < V; ++v) {
      if (frame[v] >= opt.token_min_logp || v == arg_max) {
        candidates.push_back(v);
      }
    }

    std::unordered_map<std::string, size_t> index;  // beam key -> slot
    next.clear();

    auto slot = [&](const std::string& text, const std::string& part,
                    int last_char) -> Beam& {
      std::string key;
      key.reserve(text.size() + part.size() + 8);
      key += text;
      key += '\x01';
      key += part;
      key += '\x01';
      key += std::to_string(last_char);
      auto it = index.find(key);
      if (it != index.end()) return next[it->second];
      index.emplace(std::move(key), next.size());
      next.emplace_back();
      next.back().text = text;
      next.back().word_part = part;
      next.back().last_char = last_char;
      return next.back();
    };

    for (const Beam& b : beams) {
      for (int v : candidates) {
        double p_v = frame[v];
        if (v == blank_id) {
          // Blank: composition unchanged, repeats become extendable again.
          Beam& nb = slot(b.text, b.word_part, -1);
          nb.logit_score = LogAdd(nb.logit_score, b.logit_score + p_v);
          nb.lm_score = b.lm_score;
        } else if (v == b.last_char) {
          // Repeat without an intervening blank: CTC-collapsed.
          Beam& nb = slot(b.text, b.word_part, v);
          nb.logit_score = LogAdd(nb.logit_score, b.logit_score + p_v);
          nb.lm_score = b.lm_score;
        } else if (v == word_sep_id) {
          // Word boundary: fold word_part into text and LM-score it now, so
          // the fused score drives pruning from this frame on.
          std::string text = b.text;
          double lm_acc = b.lm_score;
          if (!b.word_part.empty()) {
            lm_acc += ScoreWord(lm, text, b.word_part, opt);
            text = MergeText(text, b.word_part);
            lm_cache_has_eos.emplace(text, false);
          }
          Beam& nb = slot(text, "", v);
          nb.logit_score = LogAdd(nb.logit_score, b.logit_score + p_v);
          nb.lm_score = lm_acc;
        } else {
          Beam& nb = slot(b.text, b.word_part + vocab[v], v);
          nb.logit_score = LogAdd(nb.logit_score, b.logit_score + p_v);
          nb.lm_score = b.lm_score;
        }
      }
    }

    // Rank by fused score (acoustic + completed-word LM + partial penalty),
    // drop everything below best - beam_prune_logp, keep beam_width. Scores
    // are computed once per beam (the partial penalty does trie lookups) and
    // the sort permutes indices.
    std::vector<std::pair<double, size_t>> ranked(next.size());
    for (size_t i = 0; i < next.size(); ++i) {
      ranked[i] = {next[i].logit_score + next[i].lm_score +
                       PartialScore(next[i].word_part, opt),
                   i};
    }
    std::sort(ranked.begin(), ranked.end(),
              [](const auto& a, const auto& b) { return a.first > b.first; });
    if (!ranked.empty()) {
      double cutoff = ranked.front().first + opt.beam_prune_logp;
      size_t keep = ranked.size();
      while (keep > 1 && ranked[keep - 1].first < cutoff) --keep;
      keep = std::min(keep, static_cast<size_t>(opt.beam_width));
      std::vector<Beam> pruned;
      pruned.reserve(keep);
      for (size_t i = 0; i < keep; ++i)
        pruned.push_back(std::move(next[ranked[i].second]));
      next.swap(pruned);
    }
    beams.swap(next);
  }

  // Finalise (pyctcdecode `_merge_beams` + `_get_lm_beams(is_eos=True)`):
  // first merge beams by (text, trailing word) — last_char is dropped;
  // beams with the same composition log-sum-exp their acoustic scores and
  // share the same (path-independent) LM score. First-occurrence order is
  // kept, because the LM cache below is order-sensitive.
  {
    std::unordered_map<std::string, size_t> merged_index;
    std::vector<Beam> merged;
    merged.reserve(beams.size());
    for (Beam& b : beams) {
      std::string key = b.text;
      key += '\x01';
      key += b.word_part;
      auto it = merged_index.find(key);
      if (it == merged_index.end()) {
        merged_index.emplace(std::move(key), merged.size());
        merged.push_back(std::move(b));
      } else {
        Beam& m = merged[it->second];
        m.logit_score = LogAdd(m.logit_score, b.logit_score);
      }
    }
    beams.swap(merged);
  }

  // Trailing partial word becomes a full word; </s> (under score_boundary)
  // follows the LM cache: skipped when the final text was already scored
  // mid-beam, added (and cached with </s>, visible to later beams sharing
  // the text) when it was not.
  for (Beam& b : beams) {
    std::string new_text = MergeText(b.text, b.word_part);
    auto inserted = lm_cache_has_eos.emplace(new_text, true);
    bool add_eos = inserted.second || inserted.first->second;
    if (!b.word_part.empty()) {
      b.lm_score += ScoreWord(lm, b.text, b.word_part, opt);
      b.word_part.clear();
    }
    b.text = std::move(new_text);
    if (add_eos) b.lm_score += ScoreEos(lm, b.text, opt);
  }
  std::sort(beams.begin(), beams.end(), [](const Beam& a, const Beam& b) {
    return a.logit_score + a.lm_score > b.logit_score + b.lm_score;
  });

  std::string best = beams.empty() ? "" : beams[0].text;
  char* out = static_cast<char*>(std::malloc(best.size() + 1));
  std::memcpy(out, best.c_str(), best.size() + 1);
  return out;
}

}  // namespace coral

extern "C" {

// log_probs: (T, V) row-major natural-log probabilities. vocab: V utf-8 token
// strings; `word_sep_id` is the CTC word delimiter ('|'). `lm` may be null
// (pure acoustic beam search). `unigrams`/`hotwords` are '\n'-joined word
// lists (may be null). Caller frees the result with coral_free.
char* coral_ctc_beam_search(const float* log_probs, int T, int V,
                            const char** vocab, int blank_id, int word_sep_id,
                            int beam_width, void* lm, float alpha, float beta,
                            int lm_order, int score_boundary,
                            float beam_prune_logp, float token_min_logp,
                            const char* unigrams, float unk_score_offset,
                            const char* hotwords, float hotword_weight) {
  coral::DecodeOptions opt;
  opt.beam_width = beam_width;
  opt.alpha = alpha;
  opt.beta = beta;
  opt.lm_order = lm_order;
  opt.score_boundary = score_boundary != 0;
  opt.beam_prune_logp = beam_prune_logp;
  opt.token_min_logp = token_min_logp;
  opt.unk_score_offset = unk_score_offset;
  opt.hotword_weight = hotword_weight;

  auto parse_words = [](const char* joined) {
    std::set<std::string> out;
    if (joined == nullptr) return out;
    std::istringstream iss(joined);
    std::string w;
    while (std::getline(iss, w)) {
      if (!w.empty()) out.insert(w);
    }
    return out;
  };
  std::set<std::string> uni = parse_words(unigrams);
  std::set<std::string> hot = parse_words(hotwords);
  if (!uni.empty()) opt.unigrams = &uni;
  if (!hot.empty()) opt.hotwords = &hot;

  return coral::DecodeImpl(log_probs, T, V, vocab, blank_id, word_sep_id, lm,
                           opt);
}

void coral_free(char* p) { std::free(p); }

}  // extern "C"
