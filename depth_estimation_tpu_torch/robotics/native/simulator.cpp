#include "simulator.h"

#include <algorithm>
#include <cstdio>
#include <ctime>
#include <sstream>

namespace det {

double getTimeInSec() {
  timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (double)ts.tv_sec + 1e-9 * (double)ts.tv_nsec;
}

SimulatedAPI::SimulatedAPI(int depthMapWidth, int depthMapHeight,
                           float fixed_dt, uint64_t seed, bool default_course)
    : last_time(getTimeInSec()), delta_t(0.0f), fixed_dt(fixed_dt),
      flying(false), theta(0.0f), dtheta(0.0f),
      pitch(0.0f), gaz(0.0f), roll(0.0f), dyaw(0.0f),
      dmW(depthMapWidth), dmH(depthMapHeight),
      alpha_friction(0.5f), focal_length((float)depthMapWidth),
      rng(seed) {
  if (default_course) {
    // two rows of pillars forming a corridor (simulator.cpp:17-24)
    for (int i = 0; i < 100; ++i) {
      obstacles.push_back(Obstacle(5.f * (i + 1), -10.f + std::sin(i * 0.5f) * 2.f * i, 0.f, 1.0f));
      obstacles.push_back(Obstacle(5.f * (i + 1), +10.f + std::sin(i * 0.5f) * 2.f * i, 0.f, 1.0f));
    }
  }
}

void SimulatedAPI::next() {
  if (fixed_dt > 0.0f) {
    delta_t = fixed_dt;
  } else {
    double t = getTimeInSec();
    delta_t = (float)(t - last_time);
    last_time = t;
  }
  updatePosition(delta_t);
}

void SimulatedAPI::getDepthMap(float* out) const {
  // project sphere obstacles onto the image plane (simulator.cpp:42-74)
  const float kFar = 100.0f;
  for (int i = 0; i < dmH * dmW; ++i) out[i] = kFar;
  Vec3 p = pray(), np = npray(), u = up();
  float hh = std::floor(dmH / 2.0f), hw = std::floor(dmW / 2.0f);
  const float eps = 1e-5f;
  for (size_t o = 0; o < obstacles.size(); ++o) {
    Vec3 v = obstacles[o].center - x;
    float D = p.dot(v);
    if (D <= eps) continue;  // behind the camera
    float k = focal_length / D;
    float a = k * np.dot(v);
    float b = k * u.dot(v);
    float D2 = v.norm();
    float r = focal_length / D2 * obstacles[o].radius;
    int i0 = std::max(0, round2(a + hw - r));
    int i1 = std::min(dmW, round2(a + hw + r));
    int j0 = std::max(0, round2(b + hh - r));
    int j1 = std::min(dmH, round2(b + hh + r));
    for (int ii = i0; ii < i1; ++ii)
      for (int jj = j0; jj < j1; ++jj)
        if (D2 < out[jj * dmW + ii]) out[jj * dmW + ii] = D2;
  }
}

void SimulatedAPI::getConfidenceMap(float* out) const {
  for (int i = 0; i < dmH * dmW; ++i) out[i] = 1.0f;
}

Vec3 SimulatedAPI::getIMUTranslation() {
  Vec3 v = dx * delta_t;
  return Vec3(v.dot(pray()) + (float)rng.randn(0, 0.2),
              v.dot(npray()) + (float)rng.randn(0, 0.2),
              v.dot(up()) + (float)rng.randn(0, 0.2));
}

Vec3 SimulatedAPI::getVisualOdometryTranslation() {
  Vec3 v = dx * delta_t;
  return Vec3(v.dot(pray()) + (float)rng.randn(0, 0.1),
              v.dot(npray()) + (float)rng.randn(0, 0.1),
              v.dot(up()) + (float)rng.randn(0, 0.1));
}

Vec3 SimulatedAPI::getFilteredTranslation() {
  // variance-weighted fuse, K = var_imu / (var_imu + var_vo)
  // (simulator.cpp:105-118)
  Vec3 imu = getIMUTranslation();
  Vec3 vo = getVisualOdometryTranslation();
  float K = getIMUVariance() / (getIMUVariance() + getVisualOdometryVariance());
  return Vec3(imu.x + K * (vo.x - imu.x),
              imu.y + K * (vo.y - imu.y),
              imu.z + K * (vo.z - imu.z));
}

void SimulatedAPI::setControl(float pitch_, float gaz_, float roll_, float dyaw_) {
  pitch = pitch_;
  gaz = gaz_;
  roll = roll_;
  dyaw = dyaw_;
}

void SimulatedAPI::updatePosition(float dt) {
  if (!flying) return;
  dtheta = dyaw * dt;
  theta += dtheta;
  if (alpha_friction * dt > 1.0f)
    ddx = dx * -1.0f;
  else
    ddx = dx * -alpha_friction;
  ddx += pray() * (pitch * 10.0f);
  ddx += npray() * (roll * 10.0f);
  ddx += up() * (gaz * 10.0f);
  dx += ddx * dt;
  x += dx * dt;
}

Vec3 SimulatedAPI::pray() const { return Vec3(std::cos(theta), std::sin(theta), 0.f); }
Vec3 SimulatedAPI::npray() const { return Vec3(-std::sin(theta), std::cos(theta), 0.f); }

std::string SimulatedAPI::toString() const {
  std::ostringstream oss;
  char buf[160];
  oss << "SimulatedAPI:\n";
  std::snprintf(buf, sizeof(buf), "  x     = (%.5f %.5f %.5f)\n", x.x, x.y, x.z);
  oss << buf;
  std::snprintf(buf, sizeof(buf), "  dx    = (%.5f %.5f %.5f)\n", dx.x, dx.y, dx.z);
  oss << buf;
  std::snprintf(buf, sizeof(buf), "  theta = %.5f\n", theta);
  oss << buf;
  return oss.str();
}

}  // namespace det
