// 1-D per-angle depth estimate with per-bin variance and Kalman updates.
// Rebuild of the original ardrone/radial_depth_map.{h,hpp,cpp}.
#ifndef DET_ROBOTICS_RADIAL_DEPTH_MAP_H
#define DET_ROBOTICS_RADIAL_DEPTH_MAP_H

#include <cstddef>
#include <vector>

#include "common.h"

namespace det {

class RadialDepthMap {
 public:
  RadialDepthMap(size_t nBinsTheta, float maxDepth, float unseenDecay,
                 float focalLength);

  size_t nBinsTheta() const { return depth_.size(); }
  float depth(size_t i) const { return depth_[i]; }
  float variance(size_t i) const { return var_[i]; }
  const std::vector<float>& depths() const { return depth_; }
  const std::vector<float>& variances() const { return var_; }

  int getIThetaFromTheta(float theta) const;
  float getThetaFromITheta(size_t iTheta) const;
  float getTheta1FromITheta(size_t iTheta) const;

  // per-pixel Kalman update: K = var / (var + var_meas)
  // (radial_depth_map.cpp:23-37)
  void newPixel(float x, float y, float depth, float variance,
                float wImg, float hImg);
  // re-bin rays under an ego translation (radial_depth_map.cpp:39-77)
  void newDisplacement(const float* pos3, const float* sight3);
  // ingest the middle scanline with measurement variance 0.1
  // (radial_depth_map.cpp:79-84)
  void newFrame(const float* pixels, int w, int h);
  void to2DMap(float* out, int size) const;

  float thetaSight() const { return theta_sight_; }

 private:
  float maxDepth_, focalLength_, unseenDecay_;
  std::vector<float> depth_, var_;
  float theta_sight_;
};

}  // namespace det

#endif
