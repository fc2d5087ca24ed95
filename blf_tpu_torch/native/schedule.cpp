// Native host runtime: batch contact-schedule lowering + 2-D convex hulls.
//
// The port's own copy of blf_tpu/native/schedule.cpp (the same four extern
// "C" functions, the same arithmetic), built by blf_tpu_torch/native with
// the system g++ into blf_tpu_torch/_build/. It runs on the host, not on the
// card: before a scenario sweep launches, B contact schedules (windows per
// effector) are lowered to dense per-knot activation masks and footholds,
// and the per-knot support polygons baked to half-spaces. Pure-Python
// lowering is fine for one robot (planners/contacts.py); for tens of
// thousands of scenarios it becomes the sweep's serial bottleneck.
//
// Semantics mirror blf_tpu_torch.planners.contacts.lower_contact_schedule
// and blf_tpu_torch.planners.convex_hull exactly (tests assert equality),
// which in turn mirror the reference's ContactList/getPresentContact
// (ContactList.cpp:190-202) and ConvexHullHelper (ConvexHullHelper.cpp:35-89).
//
// Build: g++ -O3 -std=c++17 -shared -fPIC schedule.cpp -o libblf_native.so

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <vector>

extern "C" {

// Lower B×E contact lists (each up to C windows, `counts` real ones, sorted
// by activation time) onto a T-knot grid starting at t0 with spacing dt.
//
// Outputs (caller-allocated):
//   active [B,E,T]  : 1 iff a window contains the knot (act <= t < deact)
//   index  [B,E,T]  : present-contact index (last with act <= t), -1 if none
//   pos    [B,E,T,3]: foothold of the present contact (or first upcoming)
void blf_lower_schedule(const double* activation,    // [B,E,C]
                        const double* deactivation,  // [B,E,C]
                        const int32_t* counts,       // [B,E]
                        const double* positions,     // [B,E,C,3]
                        int32_t B, int32_t E, int32_t C, int32_t T,
                        double dt, double t0,
                        uint8_t* active, int32_t* index, double* pos) {
  for (int32_t b = 0; b < B; ++b) {
    for (int32_t e = 0; e < E; ++e) {
      const int64_t base = (int64_t)(b * E + e) * C;
      const double* act = activation + base;
      const double* deact = deactivation + base;
      const double* ppos = positions + base * 3;
      const int32_t n = counts[b * E + e];
      const int64_t out = (int64_t)(b * E + e) * T;

      int32_t cur = -1;  // index of last contact with act <= t (sweep)
      for (int32_t k = 0; k < T; ++k) {
        const double t = t0 + dt * k;
        while (cur + 1 < n && act[cur + 1] <= t) ++cur;
        index[out + k] = n ? cur : -1;
        const bool on = n && cur >= 0 && t < deact[cur];
        active[out + k] = on ? 1 : 0;
        const int32_t pi = n ? (cur >= 0 ? cur : 0) : -1;
        double* pk = pos + (out + k) * 3;
        if (pi >= 0) {
          pk[0] = ppos[pi * 3 + 0];
          pk[1] = ppos[pi * 3 + 1];
          pk[2] = ppos[pi * 3 + 2];
        } else {
          pk[0] = pk[1] = pk[2] = 0.0;
        }
      }
    }
  }
}

static inline double cross3(const double* o, const double* a, const double* b) {
  return (a[0] - o[0]) * (b[1] - o[1]) - (a[1] - o[1]) * (b[0] - o[0]);
}

// Andrew monotone chain, CCW, collinear points dropped.
// pts [n,2] (unsorted ok), hull_out [n+1,2]; returns vertex count.
int32_t blf_monotone_chain(const double* pts, int32_t n, double* hull_out) {
  if (n <= 0) return 0;
  std::vector<int32_t> order(n);
  for (int32_t i = 0; i < n; ++i) order[i] = i;
  std::sort(order.begin(), order.end(), [&](int32_t i, int32_t j) {
    if (pts[i * 2] != pts[j * 2]) return pts[i * 2] < pts[j * 2];
    return pts[i * 2 + 1] < pts[j * 2 + 1];
  });
  if (n <= 2) {
    int32_t k = 0;
    for (int32_t i = 0; i < n; ++i) {
      if (i && pts[order[i] * 2] == pts[order[i - 1] * 2] &&
          pts[order[i] * 2 + 1] == pts[order[i - 1] * 2 + 1])
        continue;  // dedupe
      hull_out[k * 2] = pts[order[i] * 2];
      hull_out[k * 2 + 1] = pts[order[i] * 2 + 1];
      ++k;
    }
    return k;
  }
  std::vector<double> h(2 * (n + 1) * 2);
  int32_t k = 0;
  for (int32_t ii = 0; ii < n; ++ii) {  // lower hull
    const double* p = pts + order[ii] * 2;
    while (k >= 2 && cross3(&h[(k - 2) * 2], &h[(k - 1) * 2], p) <= 0) --k;
    h[k * 2] = p[0];
    h[k * 2 + 1] = p[1];
    ++k;
  }
  const int32_t lower = k + 1;
  for (int32_t ii = n - 2; ii >= 0; --ii) {  // upper hull
    const double* p = pts + order[ii] * 2;
    while (k >= lower && cross3(&h[(k - 2) * 2], &h[(k - 1) * 2], p) <= 0) --k;
    h[k * 2] = p[0];
    h[k * 2 + 1] = p[1];
    ++k;
  }
  const int32_t count = k - 1;  // last point == first
  std::copy(h.begin(), h.begin() + count * 2, hull_out);
  return count;
}

// CCW polygon -> half-spaces with outward unit normals: A x <= b.
void blf_halfspaces(const double* hull, int32_t k, double* A, double* b) {
  for (int32_t i = 0; i < k; ++i) {
    const double* v = hull + i * 2;
    const double* w = hull + ((i + 1) % k) * 2;
    double ex = w[0] - v[0], ey = w[1] - v[1];
    const double norm = std::sqrt(ex * ex + ey * ey);
    if (norm < 1e-300) {
      A[i * 2] = 0.0;
      A[i * 2 + 1] = 0.0;
      b[i] = 1.0;  // degenerate edge -> always-true row
      continue;
    }
    A[i * 2] = ey / norm;
    A[i * 2 + 1] = -ex / norm;
    b[i] = A[i * 2] * v[0] + A[i * 2 + 1] * v[1];
  }
}

// Batched per-knot support polygons: for each (b, t) take the corner points
// of every ACTIVE effector foot, hull them, emit up to F half-spaces
// (padding rows are the always-true constraint 0·x <= 1).
void blf_support_polygons(const uint8_t* active,    // [B,E,T]
                          const double* foot_xy,    // [B,E,T,2]
                          const double* corners,    // [4,2] local offsets
                          int32_t B, int32_t E, int32_t T, int32_t F,
                          double* A_out,            // [B,T,F,2]
                          double* b_out) {          // [B,T,F]
  std::vector<double> pts(E * 4 * 2), hull((E * 4 + 1) * 2);
  std::vector<double> Arow(E * 4 * 2), brow(E * 4);
  for (int32_t b = 0; b < B; ++b) {
    for (int32_t t = 0; t < T; ++t) {
      int32_t n = 0;
      for (int32_t e = 0; e < E; ++e) {
        if (!active[((int64_t)(b * E + e)) * T + t]) continue;
        const double* c = foot_xy + (((int64_t)(b * E + e)) * T + t) * 2;
        for (int32_t j = 0; j < 4; ++j) {
          pts[n * 2] = c[0] + corners[j * 2];
          pts[n * 2 + 1] = c[1] + corners[j * 2 + 1];
          ++n;
        }
      }
      double* Ao = A_out + (((int64_t)b * T + t) * F) * 2;
      double* bo = b_out + ((int64_t)b * T + t) * F;
      int32_t k = 0;
      if (n > 0) {
        k = blf_monotone_chain(pts.data(), n, hull.data());
        if (k > F) k = F;
        blf_halfspaces(hull.data(), k, Arow.data(), brow.data());
      } else if (t > 0) {  // flight knot: reuse previous knot's polygon
        std::copy(Ao - F * 2, Ao, Ao);
        std::copy(bo - F, bo, bo);
        continue;
      }
      for (int32_t i = 0; i < F; ++i) {
        if (i < k) {
          Ao[i * 2] = Arow[i * 2];
          Ao[i * 2 + 1] = Arow[i * 2 + 1];
          bo[i] = brow[i];
        } else {
          Ao[i * 2] = 0.0;
          Ao[i * 2 + 1] = 0.0;
          bo[i] = 1.0;
        }
      }
    }
  }
}

}  // extern "C"
