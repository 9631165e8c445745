// Native host-side kernels for the offline data pipeline.
//
// Per-user alias-table negative sampling for evaluation-split construction
// and the iterative k-core filter, the two slow host loops of building a
// split. A copy of the JAX package's host library (its std::mt19937_64 draws
// are the same for the same seed), bound with ctypes by
// beta_recsys_tpu_torch/datasets/host.py, which builds it with g++ into
// build/torch_host/ at first use.

#include <cstdint>
#include <cstring>
#include <random>
#include <unordered_set>
#include <vector>

extern "C" {

// Walker alias-table construction over n frequencies.
// prob_out/alias_out must hold n entries. LIFO work-list order matches the
// Python implementation so tables are bit-identical.
void alias_build(const double* freqs, int64_t n, double* prob_out,
                 int64_t* alias_out) {
  double total = 0;
  for (int64_t i = 0; i < n; ++i) total += freqs[i];
  std::vector<int64_t> small, large;
  small.reserve(n);
  large.reserve(n);
  for (int64_t i = 0; i < n; ++i) {
    prob_out[i] = freqs[i] * n / total;
    alias_out[i] = 0;
    if (prob_out[i] < 1.0)
      small.push_back(i);
    else
      large.push_back(i);
  }
  while (!small.empty() && !large.empty()) {
    int64_t s = small.back();
    small.pop_back();
    int64_t l = large.back();
    large.pop_back();
    alias_out[s] = l;
    prob_out[l] -= (1.0 - prob_out[s]);
    if (prob_out[l] < 1.0)
      small.push_back(l);
    else
      large.push_back(l);
  }
}

// Draw `count` labels (indices into the table) with replacement.
void alias_sample(const double* prob, const int64_t* alias, int64_t n,
                  int64_t count, uint64_t seed, int64_t* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int64_t> randint(0, n - 1);
  for (int64_t i = 0; i < count; ++i) {
    int64_t idx = randint(rng);
    out[i] = (unif(rng) < prob[idx]) ? idx : alias[idx];
  }
}

// For each user u with positives pos_items[indptr[u]:indptr[u+1]], draw
// n_negative UNIQUE items from the alias table that are not positives of u.
// out is (n_users, n_negative). Mirrors feed_neg_sample's draw-dedup-truncate
// semantics with a retry loop. Returns 0 on success, -1 if a user cannot be
// filled (catalog too small).
int feed_neg_batch(const int64_t* indptr, const int64_t* pos_items,
                   int64_t n_users, const double* prob, const int64_t* alias,
                   const int64_t* labels, int64_t table_n, int64_t n_negative,
                   uint64_t seed, int64_t* out) {
  std::mt19937_64 rng(seed);
  std::uniform_real_distribution<double> unif(0.0, 1.0);
  std::uniform_int_distribution<int64_t> randint(0, table_n - 1);
  std::unordered_set<int64_t> taken;
  for (int64_t u = 0; u < n_users; ++u) {
    std::unordered_set<int64_t> pos(pos_items + indptr[u],
                                    pos_items + indptr[u + 1]);
    taken.clear();
    int64_t filled = 0;
    int64_t attempts = 0;
    const int64_t max_attempts = 100 * (n_negative + 1) + 16 * table_n;
    while (filled < n_negative) {
      if (++attempts > max_attempts) return -1;
      int64_t idx = randint(rng);
      int64_t label = labels[(unif(rng) < prob[idx]) ? idx : alias[idx]];
      if (pos.count(label) || taken.count(label)) continue;
      taken.insert(label);
      out[u * n_negative + filled++] = label;
    }
  }
  return 0;
}

// Iterative k-core filter over (user, item) interaction pairs.
// keep_out[i] = 1 if row i survives. Runs to fixed point: users need
// >= min_i_c distinct items, items need >= min_u_c distinct users.
// user/item ids must be dense in [0, n_users)/[0, n_items).
void kcore_filter(const int64_t* users, const int64_t* items, int64_t n_rows,
                  int64_t n_users, int64_t n_items, int64_t min_u_c,
                  int64_t min_i_c, uint8_t* keep_out) {
  std::memset(keep_out, 1, n_rows);
  std::vector<int64_t> user_deg(n_users), item_deg(n_items);
  bool changed = true;
  while (changed) {
    changed = false;
    std::fill(user_deg.begin(), user_deg.end(), 0);
    std::fill(item_deg.begin(), item_deg.end(), 0);
    // Degrees count interactions; distinct-count differences only matter for
    // duplicate (u, i) rows, which the pipeline dedups upstream.
    for (int64_t i = 0; i < n_rows; ++i) {
      if (!keep_out[i]) continue;
      user_deg[users[i]]++;
      item_deg[items[i]]++;
    }
    for (int64_t i = 0; i < n_rows; ++i) {
      if (!keep_out[i]) continue;
      if ((min_i_c > 0 && user_deg[users[i]] < min_i_c) ||
          (min_u_c > 0 && item_deg[items[i]] < min_u_c)) {
        keep_out[i] = 0;
        changed = true;
      }
    }
  }
}

// Distinct-count iterative k-core (the semantics the split pipeline actually
// uses — pandas groupby().nunique(), reference data_split.py:23-43):
//   a row survives iff its user has >= min_i_c DISTINCT items, its item has
//   >= min_u_c DISTINCT users, and (with uo_ids) its user has >= min_o_c
//   DISTINCT orders, all counted over surviving rows only.
// pair_ids: dense factorization of (user, item); uo_ids: of (user, order),
// or nullptr when min_o_c == 0. Simultaneous removal per round converges to
// the same (unique, maximal) fixed point as the reference's sequential
// filters: a violating row can never re-qualify, since counts only decrease.
void kcore_filter_distinct(const int64_t* users, const int64_t* items,
                           const int64_t* pair_ids, const int64_t* uo_ids,
                           int64_t n_rows, int64_t n_users, int64_t n_items,
                           int64_t n_pairs, int64_t n_uos, int64_t min_u_c,
                           int64_t min_i_c, int64_t min_o_c,
                           uint8_t* keep_out) {
  std::memset(keep_out, 1, n_rows);
  std::vector<int64_t> pair_cnt(n_pairs), uo_cnt(uo_ids ? n_uos : 0);
  std::vector<int64_t> user_items(n_users), item_users(n_items),
      user_orders(min_o_c > 0 && uo_ids ? n_users : 0);
  bool changed = true;
  while (changed) {
    changed = false;
    std::fill(pair_cnt.begin(), pair_cnt.end(), 0);
    std::fill(uo_cnt.begin(), uo_cnt.end(), 0);
    std::fill(user_items.begin(), user_items.end(), 0);
    std::fill(item_users.begin(), item_users.end(), 0);
    std::fill(user_orders.begin(), user_orders.end(), 0);
    for (int64_t r = 0; r < n_rows; ++r) {
      if (!keep_out[r]) continue;
      if (pair_cnt[pair_ids[r]]++ == 0) {
        user_items[users[r]]++;
        item_users[items[r]]++;
      }
      if (!user_orders.empty() && uo_cnt[uo_ids[r]]++ == 0)
        user_orders[users[r]]++;
    }
    for (int64_t r = 0; r < n_rows; ++r) {
      if (!keep_out[r]) continue;
      if ((min_i_c > 0 && user_items[users[r]] < min_i_c) ||
          (min_u_c > 0 && item_users[items[r]] < min_u_c) ||
          (!user_orders.empty() && user_orders[users[r]] < min_o_c)) {
        keep_out[r] = 0;
        changed = true;
      }
    }
  }
}

}  // extern "C"
