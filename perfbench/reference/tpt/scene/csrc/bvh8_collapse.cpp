// Native BVH8 collapse: binary SAH tree -> sibling-contiguous CBVH table
// with HYBRID rows (inline leaf absorption).
//
// Exact ports of the two Python reference implementations in scene/bvh8.py
// — greedy largest-surface-area expansion (policy 0) and the
// row-minimizing SAH dynamic program (policy 1, default; Ylitie et al.
// 2017 adapted to the one-gather-per-row cost model) — so each can be
// oracle-tested for bit equality. The Python loops walk the tree per child
// per expansion step which costs seconds at ~100k triangles (BENCH_r01:
// 4 s scene build, mostly here); these ports precompute subtree triangle
// ranges in O(M) and emit rows in C — sub-10 ms at that size.
//
// The hybrid table layout (every row = child stage + up to leaf_tris
// inline triangles; emission-time exact knapsack absorbs the
// highest-area small children into the parent's inline slots) is
// documented in scene/bvh8.py; the reference's structural counterpart is
// the per-thread binary BVH walk (integratorUtilities.cuh:84-186) whose
// build-time analogue is main.cu:133-233.
//
// Build: part of libtpt_native.so (see scene/native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <vector>

namespace {

constexpr int32_t kLeafBit = 1 << 30;  // per-TRIANGLE id flag (MAT_LEAF)
constexpr int kTriOff = 50;            // scene/bvh8.py TRI_OFF

inline float surf_area(const float* b) {
  float dx = std::max(b[3] - b[0], 0.0f);
  float dy = std::max(b[4] - b[1], 0.0f);
  float dz = std::max(b[5] - b[2], 0.0f);
  return 2.0f * (dx * dy + dy * dz + dz * dx);
}

}  // namespace

extern "C" {

// Returns the number of table rows written, or -1 on overflow/error.
// counts_out[0] = num 8-wide nodes, counts_out[1] = num leaf rows.
int tpt_bvh8_collapse(const int32_t* left, const int32_t* right,
                      const int32_t* leaf,   // [M,2] (first,count)
                      const float* bounds,   // [M,6]
                      int num_nodes,
                      const float* tri_pack,        // [T,9]
                      const uint8_t* tri_leaf_mat,  // [T]
                      int num_tris, int leaf_tris, int row_width,
                      int max_rows,
                      float* table,  // [max_rows, row_width] out
                      int32_t* counts_out,
                      int policy) {  // 0 = greedy, 1 = SAH DP
  const int LT = leaf_tris;
  const int RW = row_width;
  const float kInf = std::numeric_limits<float>::infinity();
  (void)num_tris;

  // subtree triangle ranges in O(M): children are allocated after their
  // parent in both builders, so a reverse index sweep sees children first
  std::vector<int32_t> rlo(num_nodes), rhi(num_nodes);
  for (int i = num_nodes - 1; i >= 0; --i) {
    if (leaf[2 * i + 1] > 0) {
      rlo[i] = leaf[2 * i];
      rhi[i] = leaf[2 * i] + leaf[2 * i + 1];
    } else {
      if (left[i] < 0 || left[i] <= i || right[i] <= i) return -1;
      rlo[i] = rlo[left[i]];
      rhi[i] = rhi[right[i]];
    }
  }

  // ---- SAH DP (policy 1): dist[n][j] = min cost (expected visited rows,
  // area surrogate) of representing subtree n as a forest of <= j roots;
  // kbest[n][j] = left-share k realizing it (-1 = single root); kint[n] =
  // 8-way split of n's internal row. Mirrors collapse_sah_py bit-for-bit
  // (float32 arithmetic, strict-< improvement, first-k tie-break).
  std::vector<float> dist;
  std::vector<int8_t> kbest, kint;
  if (policy == 1) {
    dist.assign(static_cast<size_t>(num_nodes) * 9, kInf);
    kbest.assign(static_cast<size_t>(num_nodes) * 9, -1);
    kint.assign(num_nodes, -1);
    for (int i = num_nodes - 1; i >= 0; --i) {
      float* di = dist.data() + static_cast<size_t>(i) * 9;
      if (rhi[i] - rlo[i] <= LT) {  // leaf row: always optimal, forced
        const float a = surf_area(bounds + 6 * i);
        for (int j = 1; j <= 8; ++j) di[j] = a;
        continue;
      }
      const float* dl = dist.data() + static_cast<size_t>(left[i]) * 9;
      const float* dr = dist.data() + static_cast<size_t>(right[i]) * 9;
      float best = kInf;
      int bk = -1;
      for (int k = 1; k < 8; ++k) {
        const float c = dl[k] + dr[8 - k];
        if (c < best) {
          best = c;
          bk = k;
        }
      }
      kint[i] = static_cast<int8_t>(bk);
      const float d1 = surf_area(bounds + 6 * i) + best;
      di[1] = d1;
      int8_t* ki = kbest.data() + static_cast<size_t>(i) * 9;
      for (int j = 2; j <= 8; ++j) {
        float bj = d1;
        int bkj = -1;
        for (int k = 1; k < j; ++k) {
          const float c = dl[k] + dr[j - k];
          if (c < bj) {
            bj = c;
            bkj = k;
          }
        }
        di[j] = bj;
        ki[j] = static_cast<int8_t>(bkj);
      }
    }
  }

  int cursor = 1;  // row 0 = root node row
  int n_nodes8 = 0, n_leaves8 = 0;
  std::vector<std::pair<int32_t, int32_t>> stack;  // (binary node, table row)
  stack.emplace_back(0, 0);
  int children[8];
  std::vector<std::pair<int32_t, int32_t>> fstack;  // forest walk (node, j)

  while (!stack.empty()) {
    const auto [b, my_row] = stack.back();
    stack.pop_back();

    int nc = 0;
    if (policy == 1) {
      // expand b from the DP decisions: in-order forest roots of
      // (left, kint[b]) then (right, 8 - kint[b])
      if (rhi[b] - rlo[b] <= LT) {
        children[nc++] = b;  // degenerate root: one leaf child
      } else {
        const int kb = kint[b];
        fstack.clear();
        fstack.emplace_back(right[b], 8 - kb);
        fstack.emplace_back(left[b], kb);
        while (!fstack.empty()) {
          const auto [n, j] = fstack.back();
          fstack.pop_back();
          const int k =
              j > 1 ? kbest[static_cast<size_t>(n) * 9 + j] : -1;
          if (k < 0) {
            children[nc++] = n;
          } else {
            fstack.emplace_back(right[n], j - k);
            fstack.emplace_back(left[n], k);
          }
        }
      }
    } else {
      // expand b: repeatedly split the expandable child with the largest
      // surface area (expandable = inner binary node spanning > LT tris)
      nc = 1;
      children[0] = b;
      while (nc < 8) {
        int best = -1;
        float best_a = -1.0f;
        for (int i = 0; i < nc; ++i) {
          const int c = children[i];
          if (leaf[2 * c + 1] == 0 && rhi[c] - rlo[c] > LT) {
            const float a = surf_area(bounds + 6 * c);
            if (a > best_a) {
              best = i;
              best_a = a;
            }
          }
        }
        if (best < 0) break;
        const int c = children[best];
        // children[best] -> (left, right) in place, shifting the tail
        for (int i = nc; i > best + 1; --i) children[i] = children[i - 1];
        children[best] = left[c];
        children[best + 1] = right[c];
        ++nc;
      }
    }

    // ---- hybrid absorption: exact knapsack over the small children.
    // Mirrors bvh8._knapsack_inline bit-for-bit: `small` lists child
    // indices in order, subsets enumerate by increasing bitmask, area
    // accumulates in float32 in index order, strict > keeps the first
    // best.
    int small_idx[8];
    int n_small = 0;
    for (int i = 0; i < nc; ++i) {
      const int c = children[i];
      if (rhi[c] - rlo[c] <= LT) small_idx[n_small++] = i;
    }
    int absorb_mask = 0;  // over child indices
    if (n_small > 0) {
      float best_a = 0.0f;
      int best_mask = 0;
      for (int mask = 1; mask < (1 << n_small); ++mask) {
        int w = 0;
        float a = 0.0f;
        for (int j = 0; j < n_small; ++j) {
          if (mask >> j & 1) {
            const int c = children[small_idx[j]];
            w += rhi[c] - rlo[c];
            a = a + surf_area(bounds + 6 * c);
          }
        }
        if (w <= LT && a > best_a) {
          best_a = a;
          best_mask = mask;
        }
      }
      for (int j = 0; j < n_small; ++j)
        if (best_mask >> j & 1) absorb_mask |= 1 << small_idx[j];
    }

    float* row = table + static_cast<int64_t>(my_row) * RW;
    std::memset(row, 0, sizeof(float) * RW);
    for (int j = 0; j < 48; ++j) row[j] = kInf;  // empty slots: never hit
    int32_t ids[8];
    for (int k = 0; k < LT; ++k) ids[k] = -1;
    int n_inline = 0;

    int kept[8];
    int n_kept = 0;
    for (int i = 0; i < nc; ++i) {
      if (absorb_mask >> i & 1) {
        const int c = children[i];
        for (int t = rlo[c]; t < rhi[c]; ++t) {
          std::memcpy(row + kTriOff + 9 * n_inline,
                      tri_pack + static_cast<int64_t>(t) * 9,
                      9 * sizeof(float));
          int32_t tid = t;
          if (tri_leaf_mat[t]) tid |= kLeafBit;
          ids[n_inline++] = tid;
        }
      } else {
        kept[n_kept++] = i;
      }
    }
    std::memcpy(row + kTriOff + 9 * LT, ids, LT * sizeof(int32_t));

    if (cursor + n_kept > max_rows || my_row >= max_rows) return -1;
    const int base = cursor;
    cursor += n_kept;
    ++n_nodes8;

    for (int slot = 0; slot < n_kept; ++slot) {
      const int c = children[kept[slot]];
      const float* bb = bounds + 6 * c;
      for (int ax = 0; ax < 3; ++ax) {
        row[ax * 8 + slot] = bb[ax];
        row[(3 + ax) * 8 + slot] = bb[3 + ax];
      }
      const int s = rlo[c], e = rhi[c];
      if (e - s > LT) {
        stack.emplace_back(c, base + slot);
      } else {
        ++n_leaves8;
        float* lrow = table + static_cast<int64_t>(base + slot) * RW;
        std::memset(lrow, 0, sizeof(float) * RW);
        for (int j = 0; j < 48; ++j) lrow[j] = kInf;  // no children
        int32_t lids[8];
        for (int k = 0; k < LT; ++k) lids[k] = -1;
        for (int k = 0; k < e - s; ++k) {
          std::memcpy(lrow + kTriOff + 9 * k,
                      tri_pack + static_cast<int64_t>(s + k) * 9,
                      9 * sizeof(float));
          int32_t tid = s + k;
          if (tri_leaf_mat[s + k]) tid |= kLeafBit;
          lids[k] = tid;
        }
        std::memcpy(lrow + kTriOff + 9 * LT, lids, LT * sizeof(int32_t));
      }
    }
    const int32_t zero = 0;
    std::memcpy(row + 48, &base, sizeof(int32_t));
    std::memcpy(row + 49, &zero, sizeof(int32_t));
  }

  counts_out[0] = n_nodes8;
  counts_out[1] = n_leaves8;
  return cursor;
}

}  // extern "C"
