// Native forest predictor: OpenMP over rows, per-tree traversal.
//
// The PyTorch/CUDA port's copy of lightgbm_tpu/cext/predict.cpp (the
// reference prediction hot path: src/application/predictor.hpp:30, the
// OpenMP row loop over Tree::Predict with NumericalDecision /
// CategoricalDecision, include/LightGBM/tree.h:335-412). It serves
// Booster.predict on raw matrices; each row adds its trees' leaf values
// in tree order in float64, as the numpy walk of tree.py does, so the
// two agree bit for bit. A linear tree's leaf (linear_tree) adds its
// const and then coeff x x feature after feature, as tree.py's numpy walk
// does; a NaN model feature gives the leaf's constant leaf_value.
//
// Decision-type byte layout matches the model format (tree.py):
//   bit0 = categorical, bit1 = default_left, bits2-3 = missing type
//   (0=None, 1=Zero, 2=NaN).
//
// Built at first use by lightgbm_tpu_torch/cext/__init__.py with
//   g++ -O3 -shared -fPIC -std=c++17 -fopenmp predict.cpp

#include <cmath>
#include <cstdint>

extern "C" {

static const double kZeroThreshold = 1e-35;

void lgbt_predict(
    const double* X, long n, int nfeat, int num_trees,
    const int* tree_class, int k,
    const long* node_off,        // [T+1] internal-node offsets
    const long* leaf_off,        // [T+1] leaf offsets
    const int* split_feature, const double* threshold,
    const uint8_t* decision_type, const int* left, const int* right,
    const double* leaf_value,
    const long* catb_off,        // [T+1] cat_boundaries offsets
    const long* cat_boundaries,  // flattened per tree
    const uint32_t* cat_threshold,
    const long* catt_off,        // [T+1] cat_threshold offsets
    const uint8_t* is_linear,    // [T]
    const double* leaf_const,    // [sum nl]
    const long* lfeat_off,       // [sum nl + 1] per-leaf coeff offsets
    const int* leaf_features, const double* leaf_coeff,
    int start_tree, int end_tree,
    double* out)                 // [n, k], pre-initialized by caller
{
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    const double* row = X + (size_t)i * nfeat;
    for (int t = start_tree; t < end_tree; ++t) {
      const long no = node_off[t];
      const long lo = leaf_off[t];
      const long nl = leaf_off[t + 1] - lo;
      int leaf;
      if (nl <= 1) {
        leaf = 0;
      } else {
        int node = 0;
        while (node >= 0) {
          const long j = no + node;
          const uint8_t dt = decision_type[j];
          double v = row[split_feature[j]];
          const int missing_t = (dt >> 2) & 3;
          // NaN maps to 0 unless the split's missing type is NaN
          // (reference CategoricalDecision/NumericalDecision preamble)
          if (std::isnan(v) && missing_t != 2) v = 0.0;
          bool go_left;
          if (dt & 1) {  // categorical (bitset membership -> left)
            go_left = false;
            if (std::isfinite(v) && v >= 0) {
              const long c = catb_off[t] + (long)threshold[j];
              const long wlo = cat_boundaries[c];
              const long whi = cat_boundaries[c + 1];
              // range-check in double BEFORE the int cast: huge category
              // values would overflow (int)v into a negative index
              if (v < (double)(whi - wlo) * 32.0) {
                const int iv = (int)v;
                go_left = (cat_threshold[catt_off[t] + wlo + iv / 32] >>
                           (iv % 32)) & 1u;
              }
            }
          } else {
            const bool defleft = (dt >> 1) & 1;
            if (missing_t == 1 && std::fabs(v) <= kZeroThreshold) {
              go_left = defleft;
            } else if (missing_t == 2 && std::isnan(v)) {
              go_left = defleft;
            } else {
              go_left = v <= threshold[j];
            }
          }
          node = go_left ? left[j] : right[j];
        }
        leaf = ~node;
      }
      double add;
      if (is_linear[t]) {
        const long li = lo + leaf;
        add = leaf_const[li];
        bool nan_found = false;
        for (long p = lfeat_off[li]; p < lfeat_off[li + 1]; ++p) {
          const double fv = row[leaf_features[p]];
          if (std::isnan(fv)) { nan_found = true; break; }
          add += leaf_coeff[p] * fv;
        }
        if (nan_found) add = leaf_value[lo + leaf];
      } else {
        add = leaf_value[lo + leaf];
      }
      out[(size_t)i * k + tree_class[t]] += add;
    }
  }
}

// leaf index per (row, tree) — predict_leaf_index support
void lgbt_predict_leaf(
    const double* X, long n, int nfeat, int num_trees,
    const long* node_off, const long* leaf_off,
    const int* split_feature, const double* threshold,
    const uint8_t* decision_type, const int* left, const int* right,
    const long* catb_off, const long* cat_boundaries,
    const uint32_t* cat_threshold, const long* catt_off,
    int start_tree, int end_tree,
    int* out)  // [n, end_tree - start_tree]
{
  const int span = end_tree - start_tree;
#pragma omp parallel for schedule(static)
  for (long i = 0; i < n; ++i) {
    const double* row = X + (size_t)i * nfeat;
    for (int t = start_tree; t < end_tree; ++t) {
      const long no = node_off[t];
      const long nl = leaf_off[t + 1] - leaf_off[t];
      int leaf = 0;
      if (nl > 1) {
        int node = 0;
        while (node >= 0) {
          const long j = no + node;
          const uint8_t dt = decision_type[j];
          double v = row[split_feature[j]];
          const int missing_t = (dt >> 2) & 3;
          // NaN maps to 0 unless the split's missing type is NaN
          // (reference CategoricalDecision/NumericalDecision preamble)
          if (std::isnan(v) && missing_t != 2) v = 0.0;
          bool go_left;
          if (dt & 1) {
            go_left = false;
            if (std::isfinite(v) && v >= 0) {
              const long c = catb_off[t] + (long)threshold[j];
              const long wlo = cat_boundaries[c];
              const long whi = cat_boundaries[c + 1];
              // range-check in double BEFORE the int cast: huge category
              // values would overflow (int)v into a negative index
              if (v < (double)(whi - wlo) * 32.0) {
                const int iv = (int)v;
                go_left = (cat_threshold[catt_off[t] + wlo + iv / 32] >>
                           (iv % 32)) & 1u;
              }
            }
          } else {
            const bool defleft = (dt >> 1) & 1;
            if (missing_t == 1 && std::fabs(v) <= kZeroThreshold) {
              go_left = defleft;
            } else if (missing_t == 2 && std::isnan(v)) {
              go_left = defleft;
            } else {
              go_left = v <= threshold[j];
            }
          }
          node = go_left ? left[j] : right[j];
        }
        leaf = ~node;
      }
      out[(size_t)i * span + (t - start_tree)] = leaf;
    }
  }
}

}  // extern "C"
