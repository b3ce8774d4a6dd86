// Minimal OpenCV shim: just enough cv:: surface to compile the REFERENCE
// third-order edge detector (/root/reference/src/toed/cpu_toed.cpp) as a
// ground-truth oracle binary, without an OpenCV installation. The
// reference uses OpenCV only for input conversion (image.at<uchar>) and
// the Point2d POD inside its Edge struct (include/toed/cpu_toed.hpp:28).
//
// This is NOT product code - it exists so tests/test_toed_ref_parity.py
// can diff our detector against the actual compiled reference kernel
// instead of a hand-transcribed oracle (VERDICT round 1, item 2).
#pragma once

#include <cstddef>
#include <cstdint>
#include <memory>
#include <string>
#include <vector>

typedef unsigned char uchar;

namespace cv {

struct Point2d {
  double x, y;
  Point2d() : x(0.0), y(0.0) {}
  Point2d(double x_, double y_) : x(x_), y(y_) {}
};

class Mat {
 public:
  int rows = 0, cols = 0;
  std::vector<unsigned char> buf;

  Mat() = default;
  Mat(int r, int c) : rows(r), cols(c), buf(static_cast<size_t>(r) * c) {}

  template <typename T>
  T &at(int i, int j) {
    return *reinterpret_cast<T *>(&buf[(static_cast<size_t>(i) * cols + j) *
                                       sizeof(T)]);
  }
  template <typename T>
  const T &at(int i, int j) const {
    return *reinterpret_cast<const T *>(
        &buf[(static_cast<size_t>(i) * cols + j) * sizeof(T)]);
  }
};

}  // namespace cv
