// sparse_prep: native host-side preprocessing for sparse operators.
//
// The reference keeps operators matrix-free behind a matvec callback
// (`/root/reference/include/lobpcg/linop.h`); an accelerator framework
// additionally needs *materialized* sparse operators prepared into
// device-friendly layouts:
//   - COO -> CSR conversion (operator assembly / ingest),
//   - CSR -> BSR blocking (the block-ELL SpMM consumes dense
//     (bs x bs) blocks as contiguous tiles),
//   - reverse Cuthill-McKee reordering (bandwidth reduction so BSR
//     blocks are dense and halo exchanges stay neighbor-local),
//   - contiguous row partition + halo plan for the row-sharded mesh.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in this image).
// All index types are int64 to avoid the reference's int-truncation
// defect at >2^31 elements (CODE_REVIEW.md C9).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <numeric>
#include <queue>
#include <vector>

extern "C" {

// Sort COO triplets into CSR. vals may be NULL (pattern only).
// indptr: size n+1; indices/vals_out: size nnz (caller-allocated).
// Duplicate entries are summed.  Returns the deduplicated nnz.
int64_t coo_to_csr(int64_t n, int64_t nnz, const int64_t* rows,
                   const int64_t* cols, const double* vals,
                   int64_t* indptr, int64_t* indices, double* vals_out) {
  std::vector<int64_t> order(nnz);
  std::iota(order.begin(), order.end(), 0);
  std::sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
    if (rows[a] != rows[b]) return rows[a] < rows[b];
    return cols[a] < cols[b];
  });
  std::fill(indptr, indptr + n + 1, 0);
  int64_t out = -1;
  int64_t prev_r = -1, prev_c = -1;
  for (int64_t i = 0; i < nnz; ++i) {
    const int64_t e = order[i];
    const int64_t r = rows[e], c = cols[e];
    if (r == prev_r && c == prev_c) {
      if (vals && vals_out) vals_out[out] += vals[e];
      continue;
    }
    ++out;
    indices[out] = c;
    if (vals && vals_out) vals_out[out] = vals[e];
    indptr[r + 1]++;
    prev_r = r;
    prev_c = c;
  }
  for (int64_t i = 0; i < n; ++i) indptr[i + 1] += indptr[i];
  return out + 1;
}

// Count the number of nonzero (bs x bs) blocks of a CSR matrix.
int64_t bsr_count_blocks(int64_t n, int64_t bs, const int64_t* indptr,
                         const int64_t* indices) {
  const int64_t nb = (n + bs - 1) / bs;
  std::vector<int64_t> seen(nb, -1);
  int64_t count = 0;
  for (int64_t brow = 0; brow < nb; ++brow) {
    const int64_t r0 = brow * bs;
    const int64_t r1 = std::min(r0 + bs, n);
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t bcol = indices[p] / bs;
        if (seen[bcol] != brow) {
          seen[bcol] = brow;
          ++count;
        }
      }
    }
  }
  return count;
}

// Fill BSR arrays.  block_indptr: nb+1; block_indices: nblocks;
// block_vals: nblocks*bs*bs (row-major within each block), caller-alloc.
void csr_to_bsr(int64_t n, int64_t bs, const int64_t* indptr,
                const int64_t* indices, const double* vals,
                int64_t* block_indptr, int64_t* block_indices,
                double* block_vals) {
  const int64_t nb = (n + bs - 1) / bs;
  std::vector<int64_t> pos(nb, -1);  // bcol -> slot in current block row
  int64_t nblocks = 0;
  block_indptr[0] = 0;
  for (int64_t brow = 0; brow < nb; ++brow) {
    const int64_t row_start = nblocks;
    const int64_t r0 = brow * bs;
    const int64_t r1 = std::min(r0 + bs, n);
    for (int64_t r = r0; r < r1; ++r) {
      for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
        const int64_t c = indices[p];
        const int64_t bcol = c / bs;
        int64_t slot;
        if (pos[bcol] < row_start) {
          slot = nblocks++;
          pos[bcol] = slot;
          block_indices[slot] = bcol;
          std::memset(block_vals + slot * bs * bs, 0,
                      sizeof(double) * bs * bs);
        } else {
          slot = pos[bcol];
        }
        block_vals[slot * bs * bs + (r - r0) * bs + (c - bcol * bs)] =
            vals ? vals[p] : 1.0;
      }
    }
    // Keep block columns sorted within the row for deterministic layout.
    const int64_t cnt = nblocks - row_start;
    std::vector<int64_t> ord(cnt);
    std::iota(ord.begin(), ord.end(), 0);
    std::sort(ord.begin(), ord.end(), [&](int64_t a, int64_t b) {
      return block_indices[row_start + a] < block_indices[row_start + b];
    });
    std::vector<int64_t> tmp_idx(cnt);
    std::vector<double> tmp_val(cnt * bs * bs);
    for (int64_t i = 0; i < cnt; ++i) {
      tmp_idx[i] = block_indices[row_start + ord[i]];
      std::memcpy(&tmp_val[i * bs * bs],
                  block_vals + (row_start + ord[i]) * bs * bs,
                  sizeof(double) * bs * bs);
    }
    std::memcpy(block_indices + row_start, tmp_idx.data(),
                sizeof(int64_t) * cnt);
    std::memcpy(block_vals + row_start * bs * bs, tmp_val.data(),
                sizeof(double) * cnt * bs * bs);
    block_indptr[brow + 1] = nblocks;
  }
}

// Reverse Cuthill-McKee ordering on the CSR pattern (undirected view).
// perm[i] = old index of the node placed at new position i.
void rcm_order(int64_t n, const int64_t* indptr, const int64_t* indices,
               int64_t* perm) {
  std::vector<int64_t> degree(n);
  for (int64_t i = 0; i < n; ++i) degree[i] = indptr[i + 1] - indptr[i];
  std::vector<uint8_t> visited(n, 0);
  int64_t out = 0;
  std::vector<int64_t> frontier;
  for (;;) {
    // Next start: unvisited node of minimum degree.
    int64_t start = -1;
    for (int64_t i = 0; i < n; ++i)
      if (!visited[i] && (start < 0 || degree[i] < degree[start])) start = i;
    if (start < 0) break;
    std::queue<int64_t> q;
    q.push(start);
    visited[start] = 1;
    while (!q.empty()) {
      const int64_t u = q.front();
      q.pop();
      perm[out++] = u;
      frontier.clear();
      for (int64_t p = indptr[u]; p < indptr[u + 1]; ++p) {
        const int64_t v = indices[p];
        if (v >= 0 && v < n && !visited[v]) {
          visited[v] = 1;
          frontier.push_back(v);
        }
      }
      std::sort(frontier.begin(), frontier.end(),
                [&](int64_t a, int64_t b) { return degree[a] < degree[b]; });
      for (int64_t v : frontier) q.push(v);
    }
  }
  std::reverse(perm, perm + n);  // the "reverse" in RCM
}

// Balanced contiguous row partition by nnz.  part_offsets: nparts+1.
void partition_rows(int64_t n, const int64_t* indptr, int64_t nparts,
                    int64_t* part_offsets) {
  const int64_t total = indptr[n];
  part_offsets[0] = 0;
  int64_t r = 0;
  for (int64_t p = 1; p < nparts; ++p) {
    const int64_t target = total * p / nparts;
    while (r < n && indptr[r] < target) ++r;
    part_offsets[p] = r;
  }
  part_offsets[nparts] = n;
}

// Count halo rows part `p` must receive: distinct column indices outside
// [row_lo, row_hi) referenced by rows in [row_lo, row_hi).
int64_t halo_count(int64_t row_lo, int64_t row_hi, const int64_t* indptr,
                   const int64_t* indices) {
  std::vector<int64_t> ext;
  for (int64_t r = row_lo; r < row_hi; ++r)
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      const int64_t c = indices[p];
      if (c < row_lo || c >= row_hi) ext.push_back(c);
    }
  std::sort(ext.begin(), ext.end());
  ext.erase(std::unique(ext.begin(), ext.end()), ext.end());
  return static_cast<int64_t>(ext.size());
}

// Fill the sorted distinct halo row list (size from halo_count).
void halo_fill(int64_t row_lo, int64_t row_hi, const int64_t* indptr,
               const int64_t* indices, int64_t* out) {
  std::vector<int64_t> ext;
  for (int64_t r = row_lo; r < row_hi; ++r)
    for (int64_t p = indptr[r]; p < indptr[r + 1]; ++p) {
      const int64_t c = indices[p];
      if (c < row_lo || c >= row_hi) ext.push_back(c);
    }
  std::sort(ext.begin(), ext.end());
  ext.erase(std::unique(ext.begin(), ext.end()), ext.end());
  std::memcpy(out, ext.data(), sizeof(int64_t) * ext.size());
}

}  // extern "C"
