// Rectangular linear sum assignment (shortest augmenting path with dual
// potentials — the Jonker-Volgenant / Crouse algorithm, same family as
// scipy.optimize.linear_sum_assignment).
//
// Native host-side replacement for the scipy callback in the Hungarian
// set-matching losses (toc3d_tpu/core/assigner.py): one C call per batch
// avoids python/scipy per-sample overhead in the training input pipeline.
// The reference does this matching on CPU too (hungarian_assigner_3d.py:78).
//
// Build: g++ -O3 -shared -fPIC -o liblap.so lap.cpp
extern "C" {

#include <cfloat>
#include <cstring>

// Solve min-cost assignment for cost (n_rows x n_cols), n_rows <= n_cols.
// Writes row_to_col[n_rows] (every row assigned). Returns 0 on success.
int solve_lap(const float* cost, int n_rows, int n_cols, int* row_to_col) {
    if (n_rows == 0) return 0;
    if (n_rows > n_cols) return 1;

    // dual potentials and matching
    float* u = new float[n_rows]();
    float* v = new float[n_cols]();
    int* col4row = new int[n_rows];
    int* row4col = new int[n_cols];
    float* shortest = new float[n_cols];
    bool* done = new bool[n_cols];
    int* pred = new int[n_cols];   // predecessor row for each column

    for (int i = 0; i < n_rows; ++i) col4row[i] = -1;
    for (int j = 0; j < n_cols; ++j) row4col[j] = -1;

    for (int cur_row = 0; cur_row < n_rows; ++cur_row) {
        // Dijkstra from cur_row until an unassigned column is reached
        for (int j = 0; j < n_cols; ++j) {
            shortest[j] = FLT_MAX;
            done[j] = false;
            pred[j] = -1;
        }
        float min_val = 0.0f;
        int i = cur_row;
        int sink = -1;
        while (sink == -1) {
            float lowest = FLT_MAX;
            int j_lowest = -1;
            for (int j = 0; j < n_cols; ++j) {
                if (done[j]) continue;
                float r = min_val + cost[(long)i * n_cols + j] - u[i] - v[j];
                if (r < shortest[j]) {
                    shortest[j] = r;
                    pred[j] = i;
                }
                if (shortest[j] < lowest ||
                    (shortest[j] == lowest && j_lowest >= 0 &&
                     row4col[j] == -1 && row4col[j_lowest] != -1)) {
                    lowest = shortest[j];
                    j_lowest = j;
                }
            }
            if (j_lowest < 0 || lowest == FLT_MAX) {
                // infeasible (shouldn't happen with finite costs)
                delete[] u; delete[] v; delete[] col4row; delete[] row4col;
                delete[] shortest; delete[] done; delete[] pred;
                return 2;
            }
            done[j_lowest] = true;
            min_val = lowest;
            if (row4col[j_lowest] == -1) {
                sink = j_lowest;
            } else {
                i = row4col[j_lowest];
            }
        }
        // update duals
        u[cur_row] += min_val;
        for (int k = 0; k < n_rows; ++k) {
            if (k == cur_row || col4row[k] == -1) continue;
            if (done[col4row[k]]) {
                u[k] += min_val - shortest[col4row[k]];
            }
        }
        for (int j = 0; j < n_cols; ++j) {
            if (done[j]) v[j] -= min_val - shortest[j];
        }
        // augment along the alternating path back to cur_row
        int j = sink;
        while (j != -1) {
            int ii = pred[j];
            row4col[j] = ii;
            int tmp = col4row[ii];
            col4row[ii] = j;
            j = tmp;  // previous column of row ii (to be reassigned)
            if (ii == cur_row) break;
        }
    }

    memcpy(row_to_col, col4row, n_rows * sizeof(int));
    delete[] u; delete[] v; delete[] col4row; delete[] row4col;
    delete[] shortest; delete[] done; delete[] pred;
    return 0;
}

// Batched: cost (B, n_rows, n_cols), n_valid[b] rows used per item; output
// gt_to_query (B, n_rows) with -1 for invalid rows. The cost layout matches
// assigner.hungarian_match (queries x gts), so rows here are QUERIES when
// called directly; the python wrapper transposes so rows = GTs.
int solve_lap_batched(const float* cost, int batch, int n_rows, int n_cols,
                      const int* n_valid, int* out) {
    for (int b = 0; b < batch; ++b) {
        const float* c = cost + (long)b * n_rows * n_cols;
        int* o = out + (long)b * n_rows;
        int nv = n_valid[b];
        for (int i = 0; i < n_rows; ++i) o[i] = -1;
        if (nv <= 0) continue;
        int rc = solve_lap(c, nv < n_rows ? nv : n_rows, n_cols, o);
        if (rc != 0) return rc;
    }
    return 0;
}

}  // extern "C"
