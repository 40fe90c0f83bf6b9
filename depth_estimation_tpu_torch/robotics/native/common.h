// Shared helpers for the drone runtime.
// Rebuilds the original ardrone/common.{h,cpp}: PI, round2, saturate and
// the Box-Muller gaussian sampler — with a seedable RNG so simulations are
// reproducible (the reference seeds from wall clock implicitly via rand()).
#ifndef DET_ROBOTICS_COMMON_H
#define DET_ROBOTICS_COMMON_H

#include <cmath>
#include <cstdint>
#include <string>

namespace det {

const double PI = 3.1415926535897932384626433832795028841971693993751058209;

struct Vec3 {
  float x = 0.f, y = 0.f, z = 0.f;
  Vec3() {}
  Vec3(float x, float y, float z) : x(x), y(y), z(z) {}
  float dot(const Vec3& o) const { return x * o.x + y * o.y + z * o.z; }
  float norm() const { return std::sqrt(dot(*this)); }
  Vec3 operator+(const Vec3& o) const { return Vec3(x + o.x, y + o.y, z + o.z); }
  Vec3 operator-(const Vec3& o) const { return Vec3(x - o.x, y - o.y, z - o.z); }
  Vec3 operator*(float k) const { return Vec3(x * k, y * k, z * k); }
  Vec3& operator+=(const Vec3& o) { x += o.x; y += o.y; z += o.z; return *this; }
};

template <typename T>
inline int round2(T a) { return (int)std::floor(a + (T)0.5); }

template <typename T>
inline T saturate(T a, T lo, T hi) { return a < lo ? lo : (a > hi ? hi : a); }

// xorshift128+ RNG + Box-Muller normal sampler (seedable).
class Rng {
 public:
  explicit Rng(uint64_t seed = 42) { s0_ = seed ^ 0x9e3779b97f4a7c15ULL; s1_ = seed * 0xbf58476d1ce4e5b9ULL + 1; }
  double uniform() {
    uint64_t x = s0_, y = s1_;
    s0_ = y;
    x ^= x << 23;
    s1_ = x ^ y ^ (x >> 17) ^ (y >> 26);
    return (double)((s1_ + y) >> 11) / (double)(1ULL << 53);
  }
  double randn(double mu = 0.0, double sigma = 1.0) {
    double u1 = uniform(), u2 = uniform();
    if (u1 < 1e-300) u1 = 1e-300;
    return mu + sigma * std::sqrt(-2.0 * std::log(u1)) * std::cos(2.0 * PI * u2);
  }
 private:
  uint64_t s0_, s1_;
};

double getTimeInSec();

}  // namespace det

#endif
