// Clean-room CPU baseline for the reference's third-order edge detector
// cost: reproduces the computational STRUCTURE of the reference
// (per-pixel quadruple tap loops at 4 half-pixel phases in double
// precision under OpenMP, /root/reference/src/toed/cpu_toed.cpp:122-582)
// so the framework's bench can report an honest vs-CPU factor.
// The reference publishes no numbers (BASELINE.md), so we measure this
// equivalent workload on the local host.
//
// Build: g++ -O2 -fopenmp -o ref_toed_baseline ref_toed_baseline.cpp
// Run:   ./ref_toed_baseline <H> <W> <iters>   -> prints seconds/image

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <vector>
#include <chrono>
#ifdef _OPENMP
#include <omp.h>
#endif

static const double SIG = 2.0;
static const int CENT = 8;         // 17-tap half width
static const int CENTI = 9;        // 19-tap half width

static double gtap(int kind, double p) {
  const double s = SIG;
  const double g = std::exp(-p * p / (2 * s * s));
  const double c = std::sqrt(2 * M_PI);
  switch (kind) {
    case 0: return g / (c * s);                                  // G
    case 1: return -p * g / (c * s * s * s);                     // Gx
    case 2: return (p * p - s * s) * g / (c * std::pow(s, 5));   // Gxx
    default: return p * (3 * s * s - p * p) * g / (c * std::pow(s, 7)); // Gxxx
  }
}

int main(int argc, char** argv) {
  const int H = argc > 1 ? std::atoi(argv[1]) : 376;
  const int W = argc > 2 ? std::atoi(argv[2]) : 1241;
  const int iters = argc > 3 ? std::atoi(argv[3]) : 3;

  std::vector<double> img(H * W);
  for (int i = 0; i < H * W; ++i) img[i] = (i * 2654435761u % 255);

  // Precompute the 8 tap banks (4 kinds x {0, 0.5} shift), 19 entries.
  double taps[2][4][19];
  for (int sh = 0; sh < 2; ++sh)
    for (int k = 0; k < 4; ++k)
      for (int p = -CENTI; p <= CENTI; ++p)
        taps[sh][k][p + CENTI] = gtap(k, p + 0.5 * sh);

  // Derivative products (x-kind, y-kind) in the reference's order.
  const int XK[9] = {1, 0, 2, 1, 0, 2, 1, 3, 0};
  const int YK[9] = {0, 1, 0, 1, 2, 1, 2, 0, 3};

  const int iH = 2 * H, iW = 2 * W;
  std::vector<double> Ix(iH * iW), Iy(iH * iW), mag(iH * iW), ori(iH * iW);

  double total = 0.0;
  for (int it = 0; it < iters; ++it) {
    auto t0 = std::chrono::steady_clock::now();

    // ---- convolution: per pixel, 4 phases x 9 derivatives, full 2D tap
    // loops (the reference's non-separable cost model) ----
#pragma omp parallel for schedule(dynamic)
    for (int i = 0; i < H; ++i) {
      for (int j = 0; j < W; ++j) {
        for (int sy = 0; sy < 2; ++sy) {
          for (int sx = 0; sx < 2; ++sx) {
            const int cent = (sx == 0 && sy == 0) ? CENT : CENTI;
            double f[9] = {0, 0, 0, 0, 0, 0, 0, 0, 0};
            for (int p = -cent; p <= cent; ++p) {
              const int ii = i - p;
              if (ii < 0 || ii >= H) continue;
              for (int q = -cent; q <= cent; ++q) {
                const int jj = j - q;
                if (jj < 0 || jj >= W) continue;
                const double v = img[ii * W + jj];
                for (int d = 0; d < 9; ++d)
                  f[d] += v * taps[sx][XK[d]][q + CENTI] *
                          taps[sy][YK[d]][p + CENTI];
              }
            }
            const double fx = f[0], fy = f[1], fxx = f[2], fxy = f[3],
                         fyy = f[4], fxxy = f[5], fxyy = f[6], fxxx = f[7],
                         fyyy = f[8];
            const double tix = fx * (2 * fxx * fxx + 2 * fxy * fxy) +
                               fy * (2 * fxx * fxy + 2 * fyy * fxy) +
                               2 * fx * fy * fxxy + fy * fy * fxyy +
                               fx * fx * fxxx;
            const double tiy = fx * (2 * fxx * fxy + 2 * fyy * fxy) +
                               fy * (2 * fyy * fyy + 2 * fxy * fxy) +
                               2 * fx * fy * fxyy + fx * fx * fxxy +
                               fy * fy * fyyy;
            const int oi = 2 * i + sy, oj = 2 * j + sx;
            Ix[oi * iW + oj] = fx;
            Iy[oi * iW + oj] = fy;
            mag[oi * iW + oj] = std::sqrt(fx * fx + fy * fy);
            ori[oi * iW + oj] = std::atan2(tix, -tiy);
          }
        }
      }
    }

    // ---- NMS + subpixel (directional quadrant test + parabola) ----
    volatile double sink = 0;
#pragma omp parallel for schedule(dynamic) reduction(+ : sink)
    for (int j = 10; j < iW - 10; ++j) {
      for (int i = 10; i < iH - 10; ++i) {
        const double g = mag[i * iW + j];
        if (g <= 2) continue;
        const double gx = Ix[i * iW + j], gy = Iy[i * iW + j];
        if (std::fabs(gx) < 1e-5 && std::fabs(gy) < 1e-5) continue;
        const double nx = gx / g, ny = gy / g;
        double sl, fp, fm;
        auto M = [&](int di, int dj) { return mag[(i + di) * iW + j + dj]; };
        if (gx >= 0 && gy >= 0) {
          if (gx >= gy) { sl = ny / nx; fp = M(0, 1) * (1 - sl) + M(1, 1) * sl; fm = M(0, -1) * (1 - sl) + M(-1, -1) * sl; }
          else { sl = nx / ny; fp = M(1, 0) * (1 - sl) + M(1, 1) * sl; fm = M(-1, 0) * (1 - sl) + M(-1, -1) * sl; }
        } else if (gx < 0 && gy >= 0) {
          if (-gx < gy) { sl = -nx / ny; fp = M(1, 0) * (1 - sl) + M(1, -1) * sl; fm = M(-1, 0) * (1 - sl) + M(-1, 1) * sl; }
          else { sl = -ny / nx; fp = M(0, -1) * (1 - sl) + M(1, -1) * sl; fm = M(0, 1) * (1 - sl) + M(-1, 1) * sl; }
        } else if (gx < 0 && gy < 0) {
          if (gx <= gy) { sl = ny / nx; fp = M(0, -1) * (1 - sl) + M(-1, -1) * sl; fm = M(0, 1) * (1 - sl) + M(1, 1) * sl; }
          else { sl = nx / ny; fp = M(-1, 0) * (1 - sl) + M(-1, -1) * sl; fm = M(1, 0) * (1 - sl) + M(1, 1) * sl; }
        } else {
          if (gx < -gy) { sl = -nx / ny; fp = M(-1, 0) * (1 - sl) + M(-1, 1) * sl; fm = M(1, 0) * (1 - sl) + M(1, -1) * sl; }
          else { sl = -ny / nx; fp = M(0, 1) * (1 - sl) + M(-1, 1) * sl; fm = M(0, -1) * (1 - sl) + M(1, -1) * sl; }
        }
        if ((g > fm && g >= fp) || (g >= fm && g > fp)) {
          const double s = std::sqrt(1 + sl * sl);
          const double A = (fm + fp - 2 * g) / (2 * s * s);
          const double B = (fp - fm) / (2 * s);
          const double sstar = -B / (2 * A);
          if (std::fabs(sstar) <= std::sqrt(2.0))
            sink += j + sstar * nx + i + sstar * ny;
        }
      }
    }

    auto t1 = std::chrono::steady_clock::now();
    total += std::chrono::duration<double>(t1 - t0).count();
  }

  std::printf("%.6f\n", total / iters);
  return 0;
}
