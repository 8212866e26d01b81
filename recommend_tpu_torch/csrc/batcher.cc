// Native host-side input pipeline: retrieval-batch assembly and
// popularity-weighted negative sampling. A copy of the JAX package's
// native/batcher.cc, built by recommend_tpu_torch/data/native.py with g++
// at first use into build/native/.
//
// The per-example Python loops that build left-padded history batches are
// the host hot path feeding the card; this C++ implementation assembles
// batches with tight memcpy loops and provides an O(1) alias-method sampler
// for popularity-weighted negatives (reference NegativeSampler,
// data_loader.py:212-302).
//
// Exposed with a plain C ABI and loaded via ctypes (no pybind11 dependency).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <random>
#include <vector>

extern "C" {

// Fill a left-padded retrieval training batch.
//
// Per-user sequences are flattened: item features are concatenated arrays
// indexed by seq_offsets[u] .. seq_offsets[u+1]. Example e = (user[e],
// split[e]) means: history = seq[:split] (most recent L kept), target =
// seq[split].
void fill_retrieval_batch(
    const int64_t* vids, const int64_t* cats, const int64_t* tags,
    const float* durs, const int64_t* tss,
    const int64_t* seq_offsets,
    const int64_t* ex_user, const int64_t* ex_split, int64_t batch,
    int64_t max_len,
    const float* popularity_probs,
    int64_t* out_vid, int64_t* out_cat, int64_t* out_tag, float* out_dur,
    int64_t* out_ts, uint8_t* out_valid,
    int64_t* tgt_vid, int64_t* tgt_cat, int64_t* tgt_tag, float* tgt_dur,
    int64_t* tgt_ts, float* tgt_pop) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t u = ex_user[b];
    const int64_t split = ex_split[b];
    const int64_t base = seq_offsets[u];
    const int64_t hist_len = split < max_len ? split : max_len;
    const int64_t start = base + split - hist_len;  // most recent hist_len
    const int64_t pad = max_len - hist_len;
    int64_t* ov = out_vid + b * max_len;
    int64_t* oc = out_cat + b * max_len;
    int64_t* og = out_tag + b * max_len;
    float* od = out_dur + b * max_len;
    int64_t* ot = out_ts + b * max_len;
    uint8_t* om = out_valid + b * max_len;
    std::memset(ov, 0, pad * sizeof(int64_t));
    std::memset(oc, 0, pad * sizeof(int64_t));
    std::memset(og, 0, pad * sizeof(int64_t));
    std::memset(od, 0, pad * sizeof(float));
    std::memset(ot, 0, pad * sizeof(int64_t));
    std::memset(om, 0, pad * sizeof(uint8_t));
    std::memcpy(ov + pad, vids + start, hist_len * sizeof(int64_t));
    std::memcpy(oc + pad, cats + start, hist_len * sizeof(int64_t));
    std::memcpy(og + pad, tags + start, hist_len * sizeof(int64_t));
    std::memcpy(od + pad, durs + start, hist_len * sizeof(float));
    std::memcpy(ot + pad, tss + start, hist_len * sizeof(int64_t));
    std::memset(om + pad, 1, hist_len * sizeof(uint8_t));
    const int64_t t = base + split;
    tgt_vid[b] = vids[t];
    tgt_cat[b] = cats[t];
    tgt_tag[b] = tags[t];
    tgt_dur[b] = durs[t];
    tgt_ts[b] = tss[t];
    tgt_pop[b] = popularity_probs[vids[t]];
  }
}

// Walker alias-table construction for O(1) categorical sampling.
void build_alias_table(const double* probs, int64_t n, double* prob_out,
                       int64_t* alias_out) {
  std::vector<double> scaled(n);
  double sum = 0.0;
  for (int64_t i = 0; i < n; ++i) sum += probs[i];
  for (int64_t i = 0; i < n; ++i) scaled[i] = probs[i] / sum * n;
  std::vector<int64_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    (scaled[i] < 1.0 ? small : large).push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    const int64_t s = small.back();
    small.pop_back();
    const int64_t l = large.back();
    large.pop_back();
    prob_out[s] = scaled[s];
    alias_out[s] = l;
    scaled[l] = scaled[l] + scaled[s] - 1.0;
    (scaled[l] < 1.0 ? small : large).push_back(l);
  }
  for (int64_t i : large) {
    prob_out[i] = 1.0;
    alias_out[i] = i;
  }
  for (int64_t i : small) {
    prob_out[i] = 1.0;
    alias_out[i] = i;
  }
}

// Sample `num` ids from the alias table (with replacement).
void sample_alias(const double* prob, const int64_t* alias, int64_t n,
                  int64_t num, uint64_t seed, int64_t* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int64_t> pick(0, n - 1);
  for (int64_t i = 0; i < num; ++i) {
    const int64_t j = pick(rng);
    out[i] = unif(rng) < prob[j] ? j : alias[j];
  }
}

// Sample `num` DISTINCT ids excluding a given sorted exclusion list.
// Rejection sampling against the alias table; falls back to linear scan if
// the acceptable mass is tiny.
void sample_alias_distinct_excluding(const double* prob, const int64_t* alias,
                                     int64_t n, int64_t num,
                                     const int64_t* exclude,
                                     int64_t n_exclude, uint64_t seed,
                                     int64_t* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int64_t> pick(0, n - 1);
  std::vector<int64_t> ex(exclude, exclude + n_exclude);
  std::sort(ex.begin(), ex.end());
  std::vector<int64_t> chosen;
  chosen.reserve(num);
  const int64_t max_tries = 50 * (num + 1);
  int64_t tries = 0;
  while ((int64_t)chosen.size() < num && tries < max_tries) {
    ++tries;
    const int64_t j = pick(rng);
    const int64_t id = unif(rng) < prob[j] ? j : alias[j];
    if (std::binary_search(ex.begin(), ex.end(), id)) continue;
    if (std::find(chosen.begin(), chosen.end(), id) != chosen.end()) continue;
    chosen.push_back(id);
  }
  // deterministic fallback: linear fill with any non-excluded ids
  for (int64_t id = 0; (int64_t)chosen.size() < num && id < n; ++id) {
    if (std::binary_search(ex.begin(), ex.end(), id)) continue;
    if (std::find(chosen.begin(), chosen.end(), id) != chosen.end()) continue;
    chosen.push_back(id);
  }
  std::memcpy(out, chosen.data(), chosen.size() * sizeof(int64_t));
}

// Left-pad a batch of ranking behavior sequences (ids + validity).
void fill_ranking_sequences(const int64_t* flat_ids,
                            const int64_t* offsets,  // [B+1]
                            int64_t batch, int64_t max_len, int64_t* out_ids,
                            uint8_t* out_valid) {
  for (int64_t b = 0; b < batch; ++b) {
    const int64_t start = offsets[b];
    const int64_t len_full = offsets[b + 1] - start;
    const int64_t len = len_full < max_len ? len_full : max_len;
    const int64_t src = start + len_full - len;  // keep most recent
    const int64_t pad = max_len - len;
    int64_t* oi = out_ids + b * max_len;
    uint8_t* ov = out_valid + b * max_len;
    std::memset(oi, 0, pad * sizeof(int64_t));
    std::memset(ov, 0, pad * sizeof(uint8_t));
    std::memcpy(oi + pad, flat_ids + src, len * sizeof(int64_t));
    std::memset(ov + pad, 1, len * sizeof(uint8_t));
  }
}

}  // extern "C"
