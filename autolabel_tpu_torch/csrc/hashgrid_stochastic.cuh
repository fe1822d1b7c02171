// The rows format of the stochastic-corner and residual encodes, shared by
// the forward that writes it (K6, hashgrid_stochastic.cu) and the scatter
// that reads it (K7, hashgrid_stochastic_bwd.cu), and mirrored by the host
// (encoders.stochastic_plan, encoders.stochastic_rows).
//
// Each level is of one kind with a fixed count of rows: DRAWS n_samples
// rows at weight 1 / n_samples (none stored), RESIDUAL 2 rows at w_m and
// 1 - w_m, EXACT every atom (4 simplex, 8 trilinear) at its weight. In
// training the forward writes every row's table index as (S, N) int32, S
// the sum of the levels' rows, level l's from `first[l]`, and the weights
// of the RESIDUAL and EXACT rows only as (SW, N) fp32, level l's from
// `wfirst[l]` (-1 on DRAWS levels, whose weight the scatter knows). A
// level may have any count of rows: both kernels take them in chunks.
#pragma once
#include "hashgrid_common.cuh"

#define KIND_DRAWS 0
#define KIND_RESIDUAL 1
#define KIND_EXACT 2

// Per level: its kind, its rows, the first of them among the S rows and
// the first of its weights among the SW weighted rows.
struct Plan {
  int kind[MAX_LEVELS];
  int rows[MAX_LEVELS];
  int first[MAX_LEVELS];
  int wfirst[MAX_LEVELS];
};

// Wide rows (the float4 lanes' kernels): F a multiple of 4, at least 32.
static inline bool wide_rows(int features) {
  return features % 4 == 0 && features >= 32;
}

// The plan checked against the kinds' row counts (EXACT: 4 or 8 atoms,
// every EXACT level alike; atoms > 0 also fixes that count). False where
// it does not hold.
static inline bool make_plan(Plan* plan, const int* kinds, const int* rows,
                             int levels, int atoms, int n_samples) {
  if (levels < 1 || levels > MAX_LEVELS || n_samples < 1) return false;
  int first = 0, wfirst = 0;
  for (int l = 0; l < levels; ++l) {
    const int k = kinds[l], r = rows[l];
    if (k == KIND_EXACT) {
      if (atoms <= 0) atoms = r;
      if (r != atoms || (r != 4 && r != 8)) return false;
    }
    if ((k == KIND_DRAWS && r != n_samples) ||
        (k == KIND_RESIDUAL && r != 2) || k < KIND_DRAWS || k > KIND_EXACT)
      return false;
    plan->kind[l] = k;
    plan->rows[l] = r;
    plan->first[l] = first;
    plan->wfirst[l] = k == KIND_DRAWS ? -1 : wfirst;
    first += r;
    if (k != KIND_DRAWS) wfirst += r;
  }
  return true;
}

// The weighted rows SW of a plan that make_plan accepted.
static inline int weighted_rows(const Plan& plan, int levels) {
  int sw = 0;
  for (int l = 0; l < levels; ++l)
    if (plan.kind[l] != KIND_DRAWS) sw += plan.rows[l];
  return sw;
}
