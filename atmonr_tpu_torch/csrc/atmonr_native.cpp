// Host library of atmonr_tpu_torch: multithreaded (OpenMP) geodesy and voxel
// walks for dataset and grid construction, the port's own copy of the JAX
// package's native/atmonr_native.cpp. Every entry point computes what its
// counterpart there computes, with the same arithmetic; two are new:
// atmonr_voxel_keys, the walk that writes one int64 key per voxel for the
// global grid, and atmonr_grid_h2c, the regional grids' points.
//
// A plain C interface, loaded with ctypes (atmonr_tpu_torch/native.py):
//   atmonr_build_rays       per-pixel ray construction (origins, dirs, lens)
//   atmonr_h2c / atmonr_c2h bulk WGS-84 horizontal <-> Cartesian conversion
//   atmonr_grid_h2c         a pixel grid's per-pixel terms over an altitude
//                           ladder -> (P, na, 3) Cartesian points
//   atmonr_voxel_traversal  batched Amanatides-Woo walk, int32 voxel rows
//   atmonr_voxel_keys       the same walk, one int64 key per voxel
//   atmonr_num_threads      OpenMP's thread count
//
// Built at first use by atmonr_tpu_torch/_build.py::build_host with g++ and
// the flags of native/Makefile.

#include <cmath>
#include <cstdint>
#include <limits>

#ifdef _OPENMP
#include <omp.h>
#endif

namespace {

constexpr double kA = 6378137.0;           // WGS-84 semimajor axis
constexpr double kB = 6356752.314245;      // WGS-84 semiminor axis
constexpr double kE = (kA * kA - kB * kB) / (kA * kA);   // e^2
constexpr double kE2 = (kA * kA - kB * kB) / (kB * kB);  // e'^2
constexpr double kPi = 3.14159265358979323846;
constexpr double kDeg = kPi / 180.0;

inline void horizontal_to_cartesian(double lat, double lon, double alt,
                                    double* x, double* y, double* z) {
  lat *= kDeg;
  lon *= kDeg;
  const double sin_lat = std::sin(lat);
  const double n = kA / std::sqrt(1.0 - kE * sin_lat * sin_lat);
  const double cos_lat = std::cos(lat);
  *x = (n + alt) * cos_lat * std::cos(lon);
  *y = (n + alt) * cos_lat * std::sin(lon);
  *z = (n * (1.0 - kE) + alt) * sin_lat;
}

// Bowring (1976) first-order approximation, as geo/wgs84.py computes it.
inline void cartesian_to_horizontal(double x, double y, double z, double* lat,
                                    double* lon, double* alt) {
  const double lon_r = std::atan2(y, x);
  const double d = std::sqrt(x * x + y * y);
  const double u = std::atan2(z / d, kA / kB);
  const double su = std::sin(u), cu = std::cos(u);
  const double lat_r =
      std::atan2(z + kE2 * kB * su * su * su, d - kE * kA * cu * cu * cu);
  const double sl = std::sin(lat_r);
  const double n = kA / std::sqrt(1.0 - kE * sl * sl);
  *alt = x / (std::cos(lat_r) * std::cos(lon_r)) - n;
  *lat = lat_r / kDeg;
  *lon = lon_r / kDeg;
}

// R(theta, phi) applied to +z, with the sign convention of
// geo/wgs84.py horizontal_coords_to_rot_mtx (third column of the matrix).
inline void dirvec(double theta, double phi, double* dx, double* dy,
                   double* dz) {
  const double t = -theta * kDeg, p = -phi * kDeg;
  const double st = std::sin(t), ct = std::cos(t);
  const double sp = std::sin(p), cp = std::cos(p);
  *dx = sp * st;
  *dy = -cp * st;
  *dz = ct;
}

// Rotate a +z=up-frame direction into the WGS-84 Cartesian frame
// (geo/wgs84.py compose_dirs_and_surface_normals, incl. the 180-degree
// z-rotation between the WGS frame and the scene frame).
inline void compose_dir(double dx, double dy, double dz, double lat,
                        double lon, double* ox, double* oy, double* oz) {
  const double t = -(90.0 - lat) * kDeg, p = -(90.0 - lon) * kDeg;
  const double st = std::sin(t), ct = std::cos(t);
  const double sp = std::sin(p), cp = std::cos(p);
  // z-flip: (x, y, z) -> (-x, -y, z)
  const double vx = -dx, vy = -dy, vz = dz;
  *ox = cp * vx + (-sp * ct) * vy + (sp * st) * vz;
  *oy = sp * vx + (cp * ct) * vy + (-cp * st) * vz;
  *oz = st * vy + ct * vz;
}

// Amanatides & Woo (1987) walk of the segment ui -> ei through unit voxels,
// step for step as extract/voxel_traversal.py walks it: the start voxel
// first; an axis freezes once it reaches its destination coordinate; the
// walk ends when every axis has arrived or any axis overshot. Calls
// visit(vox, k) for the k-th voxel and returns the number of voxels.
template <class Visit>
int64_t walk_segment(const double* ui, const double* ei, Visit visit) {
  const double kInf = std::numeric_limits<double>::infinity();
  int32_t vox[3], vend[3], sgn[3];
  double tmax[3], tdelta[3];
  double d2 = 0.0;
  for (int d = 0; d < 3; ++d) {
    const double dd = ei[d] - ui[d];
    d2 += dd * dd;
  }
  const double dist = std::sqrt(d2);
  for (int d = 0; d < 3; ++d) {
    vox[d] = static_cast<int32_t>(std::floor(ui[d]));
    vend[d] = static_cast<int32_t>(std::floor(ei[d]));
    const double v = dist > 0.0 ? (ei[d] - ui[d]) / dist : 0.0;
    sgn[d] = (v > 0.0) - (v < 0.0);
    if (sgn[d] == 0 || vox[d] == vend[d]) {
      tmax[d] = kInf;
      tdelta[d] = kInf;
    } else {
      const double svu = sgn[d] * ui[d];
      tmax[d] = std::fabs((std::ceil(svu) - svu) / v);
      tdelta[d] = std::fabs(1.0 / v);
    }
  }
  int64_t count = 0;
  visit(vox, count++);
  bool all_arrived = true, overshot = false;
  for (int d = 0; d < 3; ++d) {
    const int64_t diff = static_cast<int64_t>(vox[d] - vend[d]) * sgn[d];
    all_arrived &= diff == 0;
    overshot |= diff > 0;
  }
  bool done = all_arrived || overshot;
  while (!done) {
    int axis = 0;
    if (tmax[1] < tmax[axis]) axis = 1;
    if (tmax[2] < tmax[axis]) axis = 2;
    tmax[axis] += tdelta[axis];
    vox[axis] += sgn[axis];
    visit(vox, count++);
    bool all_nonneg = true;
    overshot = false;
    for (int d = 0; d < 3; ++d) {
      const int64_t diff = static_cast<int64_t>(vox[d] - vend[d]) * sgn[d];
      if (diff >= 0) tmax[d] = kInf;  // axis arrived: freeze it
      all_nonneg &= diff >= 0;
      overshot |= diff > 0;
    }
    done = all_nonneg || overshot;
  }
  return count;
}

}  // namespace

extern "C" {

// Per-pixel ray construction. Inputs are float32 arrays of length n (NaNs
// propagate to NaN outputs, which filter_rays drops later). Outputs:
// origins (n,3), dirs (n,3), lens (n) float32.
void atmonr_build_rays(const float* lat, const float* lon, const float* alt,
                       const float* thetav, const float* phiv, int64_t n,
                       double ray_origin_height, double tol, int max_iters,
                       float* origins, float* dirs, float* lens) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    double x, y, z;
    horizontal_to_cartesian(lat[i], lon[i], alt[i], &x, &y, &z);
    // the float32 rounding of the surface point, as the numpy path has it
    x = static_cast<double>(static_cast<float>(x));
    y = static_cast<double>(static_cast<float>(y));
    z = static_cast<double>(static_cast<float>(z));

    double dx, dy, dz;
    dirvec(thetav[i], phiv[i], &dx, &dy, &dz);
    double cx, cy, cz;
    compose_dir(dx, dy, dz, lat[i], lon[i], &cx, &cy, &cz);
    // flip: top of atmosphere is the origin
    cx = -cx;
    cy = -cy;
    cz = -cz;

    // fixed-point iteration on the ray length so the origin sits at
    // ray_origin_height above the ellipsoid; each ray stops on its own
    double len =
        (ray_origin_height - static_cast<double>(alt[i])) /
        std::cos(static_cast<double>(thetav[i]) * kDeg);
    double la, lo, alt_check;
    for (int it = 0; it <= max_iters; ++it) {
      const double px = x - len * cx, py = y - len * cy, pz = z - len * cz;
      cartesian_to_horizontal(px, py, pz, &la, &lo, &alt_check);
      if (std::fabs(ray_origin_height - alt_check) <= tol) break;
      len *= ray_origin_height / alt_check;
    }
    len = static_cast<double>(static_cast<float>(len));
    origins[3 * i + 0] = static_cast<float>(x - cx * len);
    origins[3 * i + 1] = static_cast<float>(y - cy * len);
    origins[3 * i + 2] = static_cast<float>(z - cz * len);
    dirs[3 * i + 0] = static_cast<float>(cx);
    dirs[3 * i + 1] = static_cast<float>(cy);
    dirs[3 * i + 2] = static_cast<float>(cz);
    lens[i] = static_cast<float>(len);
  }
}

void atmonr_h2c(const double* lat, const double* lon, const double* alt,
                int64_t n, double* x, double* y, double* z) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    horizontal_to_cartesian(lat[i], lon[i], alt[i], &x[i], &y[i], &z[i]);
  }
}

// The points of P pixels over an altitude ladder of na steps, from the
// pixels' terms as geo/wgs84.py horizontal_grid_to_cartesian computes them
// (n, n (1 - e^2), cos lat, cos lon, sin lon, sin lat; each (P,)): out is
// (P, na, 3), each point's three coordinates next to each other. The same
// float64 operations in the same order as there, and no product feeds a
// sum, so no multiply-add can form: the points are bit-equal. One OpenMP
// task per pixel: each thread first touches the rows it writes.
void atmonr_grid_h2c(const double* n, const double* nz, const double* cos_lat,
                     const double* cos_lon, const double* sin_lon,
                     const double* sin_lat, int64_t p, const double* alt,
                     int64_t na, double* out) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < p; ++i) {
    double* row = out + 3 * na * i;
    for (int64_t a = 0; a < na; ++a) {
      const double t = (n[i] + alt[a]) * cos_lat[i];
      row[3 * a + 0] = t * cos_lon[i];
      row[3 * a + 1] = t * sin_lon[i];
      row[3 * a + 2] = (nz[i] + alt[a]) * sin_lat[i];
    }
  }
}

void atmonr_c2h(const double* x, const double* y, const double* z, int64_t n,
                double* lat, double* lon, double* alt) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    cartesian_to_horizontal(x[i], y[i], z[i], &lat[i], &lon[i], &alt[i]);
  }
}

// Batched walk of the n segments u[i] -> end[i] (continuous voxel
// coordinates, (n,3) float64), one OpenMP task per segment. Two passes:
// with out_vox = NULL it writes the per-segment counts only; then, with
// offsets = the exclusive prefix sum of the counts, it writes each
// segment's voxels (int32 rows) from its offset, so the output does not
// depend on the threads.
void atmonr_voxel_traversal(const double* u, const double* end, int64_t n,
                            const int64_t* offsets, int32_t* out_vox,
                            int32_t* out_counts) {
#pragma omp parallel for schedule(static)
  for (int64_t i = 0; i < n; ++i) {
    int32_t* out = out_vox ? out_vox + 3 * offsets[i] : nullptr;
    out_counts[i] = static_cast<int32_t>(walk_segment(
        u + 3 * i, end + 3 * i, [out](const int32_t* vox, int64_t k) {
          if (out) {
            out[3 * k + 0] = vox[0];
            out[3 * k + 1] = vox[1];
            out[3 * k + 2] = vox[2];
          }
        }));
  }
}

// The walk of atmonr_voxel_traversal with one int64 key per voxel in place
// of its row: the offset from lo in mixed radix width,
// ((v0 - lo0) * width1 + (v1 - lo1)) * width2 + (v2 - lo2), which orders the
// keys as the rows order lexicographically. The same two passes (out_keys =
// NULL for the counts). The write pass returns the number of voxels outside
// the box [lo, lo + width), whose keys it writes as -1; the count pass
// returns 0.
int64_t atmonr_voxel_keys(const double* u, const double* end, int64_t n,
                          const int64_t* lo, const int64_t* width,
                          const int64_t* offsets, int64_t* out_keys,
                          int32_t* out_counts) {
  int64_t outside = 0;
#pragma omp parallel for schedule(static) reduction(+ : outside)
  for (int64_t i = 0; i < n; ++i) {
    int64_t* out = out_keys ? out_keys + offsets[i] : nullptr;
    out_counts[i] = static_cast<int32_t>(walk_segment(
        u + 3 * i, end + 3 * i,
        [out, lo, width, &outside](const int32_t* vox, int64_t k) {
          if (!out) return;
          int64_t key = 0;
          bool inside = true;
          for (int d = 0; d < 3; ++d) {
            const int64_t rel = static_cast<int64_t>(vox[d]) - lo[d];
            inside &= rel >= 0 && rel < width[d];
            key = key * width[d] + rel;
          }
          if (!inside) {
            key = -1;
            ++outside;
          }
          out[k] = key;
        }));
  }
  return outside;
}

int atmonr_num_threads() {
#ifdef _OPENMP
  return omp_get_max_threads();
#else
  return 1;
#endif
}

}  // extern "C"
