// Native host-side data layer: greedy bin finding, the numeric bound
// search, whole-matrix quantization, sample transpose and text parsing.
//
// The PyTorch/CUDA port's copy of lightgbm_tpu/cext/binning.cpp (the
// reference's C++ data-ingestion hot paths: GreedyFindBin,
// src/io/bin.cpp:78; the OpenMP FindBin and bin-construction loops of
// dataset_loader.cpp; the CSV/TSV parsers, src/io/parser.cpp). Reached
// from Python via ctypes (lightgbm_tpu_torch/cext/__init__.py), which
// builds it at first use with
//   g++ -O3 -shared -fPIC -std=c++17 -fopenmp binning.cpp
// Every routine is bit-exact with the numpy path of binning.py; the
// parallel loops write disjoint outputs, so the thread count never
// changes a bit.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <limits>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Greedy bin finding over distinct values (behavior of bin.cpp:78-150):
// values with counts >= mean bin size get dedicated bins; the rest are
// packed greedily to equalize bin populations. Returns number of bounds
// written to out_bounds (last is +inf).
// ---------------------------------------------------------------------------
int lgbt_greedy_find_bin(const double* distinct, const int* counts,
                         int num_distinct, int max_bin, long total_cnt,
                         int min_data_in_bin, double* out_bounds) {
  int nb = 0;
  if (num_distinct == 0) {
    out_bounds[nb++] = std::numeric_limits<double>::infinity();
    return nb;
  }
  auto check_eq = [](double a, double b) {
    double tol = 1e-9 * std::max(std::fabs(a), std::fabs(b));
    return a <= b + tol && a >= b - tol;
  };
  if (num_distinct <= max_bin) {
    int cur = 0;
    for (int i = 0; i < num_distinct - 1; ++i) {
      cur += counts[i];
      if (cur >= min_data_in_bin) {
        double v = (distinct[i] + distinct[i + 1]) / 2.0;
        if (nb == 0 || !check_eq(out_bounds[nb - 1], v)) {
          out_bounds[nb++] = v;
          cur = 0;
        }
      }
    }
    out_bounds[nb++] = std::numeric_limits<double>::infinity();
    return nb;
  }
  if (min_data_in_bin > 0) {
    long capped = std::min<long>(max_bin, total_cnt / min_data_in_bin);
    max_bin = static_cast<int>(std::max<long>(1, capped));
  }
  double mean_size = static_cast<double>(total_cnt) / max_bin;
  std::vector<char> is_big(num_distinct, 0);
  int rest_bins = max_bin;
  long rest_cnt = total_cnt;
  for (int i = 0; i < num_distinct; ++i) {
    if (counts[i] >= mean_size) {
      is_big[i] = 1;
      --rest_bins;
      rest_cnt -= counts[i];
    }
  }
  mean_size = static_cast<double>(rest_cnt) / std::max(rest_bins, 1);
  std::vector<double> uppers, lowers;
  lowers.push_back(distinct[0]);
  int cur = 0;
  for (int i = 0; i < num_distinct - 1; ++i) {
    if (!is_big[i]) rest_cnt -= counts[i];
    cur += counts[i];
    if (is_big[i] || cur >= mean_size ||
        (is_big[i + 1] && cur >= std::max(1.0, mean_size * 0.5))) {
      uppers.push_back(distinct[i]);
      lowers.push_back(distinct[i + 1]);
      if (static_cast<int>(uppers.size()) >= max_bin - 1) break;
      cur = 0;
      if (!is_big[i]) {
        --rest_bins;
        mean_size = rest_cnt / static_cast<double>(std::max(rest_bins, 1));
      }
    }
  }
  for (size_t i = 0; i < uppers.size(); ++i) {
    double v = (uppers[i] + lowers[i + 1]) / 2.0;
    if (nb == 0 || !check_eq(out_bounds[nb - 1], v)) out_bounds[nb++] = v;
  }
  out_bounds[nb++] = std::numeric_limits<double>::infinity();
  return nb;
}

// ---------------------------------------------------------------------------
// Distinct-value extraction from a sorted sample (bin.cpp:355-380 behavior):
// merges near-equal neighbours keeping the larger value. Returns count.
// ---------------------------------------------------------------------------
int lgbt_distinct(const double* sorted_values, int n, double* out_vals,
                  int* out_counts) {
  if (n == 0) return 0;
  int k = 0;
  out_vals[0] = sorted_values[0];
  out_counts[0] = 1;
  for (int i = 1; i < n; ++i) {
    double prev = out_vals[k];
    double tol = 1e-9 * std::max(std::fabs(prev),
                                 std::fabs(sorted_values[i]));
    if (sorted_values[i] > prev + tol) {
      ++k;
      out_vals[k] = sorted_values[i];
      out_counts[k] = 1;
    } else {
      out_vals[k] = sorted_values[i];  // keep larger
      ++out_counts[k];
    }
  }
  return k + 1;
}

// ---------------------------------------------------------------------------
// Buffered delimited-text parser (reference src/io/parser.cpp CSVParser /
// TSVParser + pipeline_reader.h). Parses a whole file of numeric rows into
// a dense row-major buffer. Returns rows parsed, or -1 on error;
// *out_cols reports detected column count.
// ---------------------------------------------------------------------------
long lgbt_parse_delimited(const char* path, char delim, int skip_rows,
                          double* out, long max_rows, int max_cols,
                          int* out_cols) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long fsize = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::vector<char> buf(fsize + 1);
  long rd = static_cast<long>(std::fread(buf.data(), 1, fsize, fp));
  std::fclose(fp);
  buf[rd] = '\0';

  long row = 0;
  int ncols = -1;
  char* p = buf.data();
  char* end = buf.data() + rd;
  for (int s = 0; s < skip_rows && p < end; ++s) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }
  while (p < end && row < max_rows) {
    if (*p == '\n' || *p == '\r') { ++p; continue; }
    int col = 0;
    while (p < end && *p != '\n') {
      char* q;
      double v = std::strtod(p, &q);
      if (q == p) {  // unparsable token; skip to next delim
        while (p < end && *p != delim && *p != '\n') ++p;
        v = std::nan("");
      } else {
        p = q;
      }
      if (col < max_cols) out[row * max_cols + col] = v;
      ++col;
      if (p < end && *p == delim) ++p;
      else break;
    }
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
    if (ncols < 0) ncols = col;
    for (int c = col; c < max_cols && c < ncols; ++c)
      out[row * max_cols + c] = 0.0;
    ++row;
  }
  *out_cols = ncols < 0 ? 0 : std::min(ncols, max_cols);
  return row;
}

// Count rows/columns for pre-allocation.
long lgbt_count_rows(const char* path, char delim, int* out_cols) {
  FILE* fp = std::fopen(path, "rb");
  if (!fp) return -1;
  std::vector<char> chunk(1 << 20);
  long rows = 0;
  int cols = 1;
  bool first_line = true;
  bool line_started = false;
  size_t got;
  while ((got = std::fread(chunk.data(), 1, chunk.size(), fp)) > 0) {
    for (size_t i = 0; i < got; ++i) {
      char c = chunk[i];
      if (c == '\n') {
        if (line_started) ++rows;
        first_line = false;
        line_started = false;
      } else if (c != '\r') {
        line_started = true;
        if (first_line && c == delim) ++cols;
      }
    }
  }
  if (line_started) ++rows;
  std::fclose(fp);
  *out_cols = cols;
  return rows;
}

// ---------------------------------------------------------------------------
// Vectorized value->bin mapping (bin.h:149 ValueToBin): branchless binary
// search over upper bounds, NaN -> nan_bin (or default_bin).
// ---------------------------------------------------------------------------
void lgbt_values_to_bins(const double* values, long n, const double* bounds,
                         int num_search_bounds, int nan_bin, uint8_t* out) {
  for (long i = 0; i < n; ++i) {
    double v = values[i];
    if (std::isnan(v)) {
      out[i] = static_cast<uint8_t>(nan_bin);
      continue;
    }
    int lo = 0, hi = num_search_bounds;
    while (lo < hi) {
      int mid = (lo + hi) >> 1;
      if (bounds[mid] < v) lo = mid + 1;
      else hi = mid;
    }
    out[i] = static_cast<uint8_t>(lo);
  }
}

// ---------------------------------------------------------------------------
// Whole-matrix quantization (the DatasetLoader OMP bin-construction analog,
// dataset_loader.cpp): one pass over row-major X binning every used numeric
// feature, parallel over rows so each thread streams X sequentially.
//
// Each feature gets a small uniform grid over its bound range; grid cell c
// stores the insertion point of the cell's lower edge, so a value's binary
// search is confined to [grid[c], grid[c+1]] — typically 0-2 bounds. Never
// slower than a full binary search, ~4-6x fewer compares at max_bin=255.
// bounds_flat/bounds_off: concatenated per-feature search bounds.
// elem_size: 1 (uint8 out) or 2 (uint16 out); out is [n, n_used] row-major.
// ---------------------------------------------------------------------------
void lgbt_bin_matrix(const void* Xv, int x_is_f32, long n, int f_total,
                     const int* feat_idx, int n_used,
                     const double* bounds_flat, const long* bounds_off,
                     const int* num_search, const int* nan_bin,
                     int elem_size, void* out) {
  const double* X64 = static_cast<const double*>(Xv);
  const float* X32 = static_cast<const float*>(Xv);
  uint8_t* out8 = static_cast<uint8_t*>(out);
  uint16_t* out16 = static_cast<uint16_t*>(out);
  // grid cells per feature. Quantile-derived bounds cluster where the
  // data mass is (center cells of a randn feature hold many bounds at
  // coarse G, re-growing the per-value search); 2048 cells keep the
  // common cell at 0-1 candidates while the whole table stays
  // L2-resident (u16 x 2049 x n_used: ~115 KB at 28 features).
  const int G = 2048;
  std::vector<uint16_t> grid(static_cast<size_t>(n_used) * (G + 1));
  std::vector<double> glo(n_used), ginv(n_used);
  for (int j = 0; j < n_used; ++j) {
    const double* bnd = bounds_flat + bounds_off[j];
    int ns = num_search[j];
    uint16_t* gj = grid.data() + static_cast<size_t>(j) * (G + 1);
    if (ns <= 0) {
      glo[j] = 0.0; ginv[j] = 0.0;
      for (int c = 0; c <= G; ++c) gj[c] = 0;
      continue;
    }
    double lo_v = bnd[0], hi_v = bnd[ns - 1];
    double span = hi_v - lo_v;
    if (!(span > 0)) span = 1.0;
    glo[j] = lo_v;
    ginv[j] = G / span;
    for (int c = 0; c <= G; ++c) {
      double edge = lo_v + span * c / G;
      int s = 0, e = ns;
      while (s < e) {
        int mid = (s + e) >> 1;
        if (bnd[mid] < edge) s = mid + 1;
        else e = mid;
      }
      gj[c] = static_cast<uint16_t>(s);
    }
    gj[G] = static_cast<uint16_t>(ns);
  }
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (long i = 0; i < n; ++i) {
    const long row0 = i * f_total;
    for (int j = 0; j < n_used; ++j) {
      double v = x_is_f32
          ? static_cast<double>(X32[row0 + feat_idx[j]])
          : X64[row0 + feat_idx[j]];
      int b;
      if (std::isnan(v)) {
        b = nan_bin[j];
      } else {
        const double* bnd = bounds_flat + bounds_off[j];
        const uint16_t* gj = grid.data() + static_cast<size_t>(j) * (G + 1);
        double t = (v - glo[j]) * ginv[j];
        // !(t > 0) also catches NaN t (0*inf from degenerate spans /
        // infinite values) — casting NaN to int is UB and would index
        // the grid out of bounds
        int c = !(t > 0) ? 0 : (t >= G ? G - 1 : static_cast<int>(t));
        int lo = gj[c], hi = gj[c + 1];
        while (lo < hi) {
          int mid = (lo + hi) >> 1;
          if (bnd[mid] < v) lo = mid + 1;
          else hi = mid;
        }
        b = lo;
        // exactness fix-up: grid edges are recomputed in floating point,
        // so the narrowed range can miss by one bound at a cell edge
        while (b > 0 && bnd[b - 1] >= v) --b;
        while (b < num_search[j] && bnd[b] < v) ++b;
      }
      if (elem_size == 1) out8[i * n_used + j] = static_cast<uint8_t>(b);
      else out16[i * n_used + j] = static_cast<uint16_t>(b);
    }
  }
}

// ---------------------------------------------------------------------------
// Fused sample gather + transpose + float64 cast for mapper construction:
// out[f, i] = (double) X[idx[i], f], out row-major [f_total, n_idx].
// Replaces the NumPy chain X[idx] (row gather) -> .T -> ascontiguousarray
// (strided transpose-cast) — two full passes over the sample — with one
// streaming pass: idx is sorted, so row reads walk X forward, and for a
// fixed thread the writes advance f_total sequential column streams.
// ---------------------------------------------------------------------------
void lgbt_sample_transpose(const void* Xv, int x_is_f32, int f_total,
                           const long* idx, long n_idx, double* out) {
  const double* X64 = static_cast<const double*>(Xv);
  const float* X32 = static_cast<const float*>(Xv);
#if defined(_OPENMP)
#pragma omp parallel for schedule(static)
#endif
  for (long i = 0; i < n_idx; ++i) {
    const long row0 = idx[i] * static_cast<long>(f_total);
    for (int f = 0; f < f_total; ++f) {
      out[static_cast<long>(f) * n_idx + i] =
          x_is_f32 ? static_cast<double>(X32[row0 + f]) : X64[row0 + f];
    }
  }
}

// ---------------------------------------------------------------------------
// Whole-matrix numeric bin-boundary search (the per-feature FindBin loop of
// DatasetLoader::ConstructBinMappersFromTextData, dataset_loader.cpp:~690,
// with bin.cpp:325-404 FindBin + :256 FindBinWithZeroAsOneBin semantics).
// Behavior-exact mirror of binning.py from_sample's numeric path so the
// native and NumPy pipelines produce identical mappers.
//
// sample_t: [n_feat, s] feature-major contiguous sample (raw values incl.
// zeros and NaNs). Per feature writes <= max_bin+1 bounds at stride
// (max_bin + 2) into bounds_out plus the mapper metadata scalars.
// ---------------------------------------------------------------------------
static int zero_as_one_bin(const double* distinct, const int* counts,
                           int n, int max_bin, long total_cnt,
                           int min_data_in_bin, double* out) {
  // mirror of binning.py _find_bin_zero_as_one
  const double kZero = 1e-35;
  const double kInf = std::numeric_limits<double>::infinity();
  if (n == 0) {
    out[0] = kInf;
    return 1;
  }
  long left_cnt_data = 0, right_cnt_data = 0;
  int left_cnt = n, right_start = -1;
  for (int i = 0; i < n; ++i) {
    if (distinct[i] <= -kZero) {
      left_cnt_data += counts[i];
    } else if (distinct[i] > kZero) {
      right_cnt_data += counts[i];
      if (right_start < 0) right_start = i;
    }
    if (distinct[i] > -kZero && left_cnt == n) left_cnt = i;
  }
  int nb = 0;
  if (left_cnt > 0) {
    int left_max_bin = std::max(
        1, static_cast<int>(static_cast<double>(left_cnt_data) /
                            std::max<long>(total_cnt, 1) / 2.0 *
                            (max_bin - 1)));
    nb = lgbt_greedy_find_bin(distinct, counts, left_cnt, left_max_bin,
                              left_cnt_data, min_data_in_bin, out);
    out[nb - 1] = -kZero;
  }
  if (right_start >= 0) {
    int right_max_bin = max_bin - 1 - nb;
    if (right_max_bin > 0) {
      out[nb++] = kZero;
      nb += lgbt_greedy_find_bin(distinct + right_start,
                                 counts + right_start, n - right_start,
                                 right_max_bin, right_cnt_data,
                                 min_data_in_bin, out + nb);
    } else {
      out[nb++] = kInf;
    }
  } else {
    out[nb++] = kInf;
  }
  return nb;
}

int lgbt_find_numeric_bounds(const double* sample_t, int n_feat, long s,
                             int max_bin, int min_data_in_bin,
                             int use_missing, int zero_as_missing,
                             double* bounds_out, int* nb_out,
                             int* mtype_out, double* minmax_out,
                             long* zero_na_out) {
  const double kZero = 1e-35;
  const int stride = max_bin + 2;
#if defined(_OPENMP)
#pragma omp parallel
#endif
  {
    std::vector<double> vals(s), dvals(s + 1);
    std::vector<int> dcnts(s + 1);
#if defined(_OPENMP)
#pragma omp for schedule(dynamic)
#endif
    for (int fj = 0; fj < n_feat; ++fj) {
      const double* col = sample_t + static_cast<long>(fj) * s;
      long nv = 0, na = 0;
      for (long i = 0; i < s; ++i) {
        double v = col[i];
        if (std::isnan(v)) {
          ++na;
        } else if (std::fabs(v) > kZero) {
          vals[nv++] = v;
        }
      }
      long zero_cnt = s - nv - na;
      int mtype = 0;  // NONE
      if (use_missing) {
        if (zero_as_missing) mtype = 1;       // ZERO
        else if (na > 0) mtype = 2;           // NAN
      }
      std::sort(vals.begin(), vals.begin() + nv);
      int nd = lgbt_distinct(vals.data(), static_cast<int>(nv),
                             dvals.data(), dcnts.data());
      if (zero_cnt > 0 || nd == 0) {
        // splice zero at its sorted position (binning.py:205-209)
        int pos = static_cast<int>(
            std::lower_bound(dvals.data(), dvals.data() + nd, 0.0) -
            dvals.data());
        if (pos >= nd || std::fabs(dvals[pos]) > kZero) {
          for (int i = nd; i > pos; --i) {
            dvals[i] = dvals[i - 1];
            dcnts[i] = dcnts[i - 1];
          }
          dvals[pos] = 0.0;
          dcnts[pos] = static_cast<int>(std::max<long>(zero_cnt, 0));
          ++nd;
        }
      }
      minmax_out[2 * fj] = nd ? dvals[0] : 0.0;
      minmax_out[2 * fj + 1] = nd ? dvals[nd - 1] : 0.0;
      double* bout = bounds_out + static_cast<long>(fj) * stride;
      int nb;
      if (mtype == 2) {
        nb = zero_as_one_bin(dvals.data(), dcnts.data(), nd, max_bin - 1,
                             s - na, min_data_in_bin, bout);
        bout[nb++] = std::numeric_limits<double>::quiet_NaN();
      } else {
        nb = zero_as_one_bin(dvals.data(), dcnts.data(), nd, max_bin,
                             s, min_data_in_bin, bout);
        if (mtype == 1 && nb == 2) mtype = 0;  // ZERO w/o split -> NONE
      }
      nb_out[fj] = nb;
      mtype_out[fj] = mtype;
      zero_na_out[2 * fj] = zero_cnt;
      zero_na_out[2 * fj + 1] = na;
    }
  }
  return 0;
}

}  // extern "C"
