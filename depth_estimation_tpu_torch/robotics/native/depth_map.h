// Polar (theta, rho) occupancy depth map with ray evidence updates and the
// obstacle-avoidance steering decision. Rebuild of
// the original ardrone/depth_map.{h,hpp,cpp} with the linear rho binning
// the reference actually exercises (its getIRhoFromRho2 family) on a flat
// float buffer. One deliberate fix: getSafeTheta wraps theta indices
// (the reference indexes vectors with possibly-negative iTheta — UB).
#ifndef DET_ROBOTICS_DEPTH_MAP_H
#define DET_ROBOTICS_DEPTH_MAP_H

#include <cstddef>
#include <string>
#include <vector>

#include "common.h"

namespace det {

class DepthMap {
 public:
  DepthMap(size_t nBinsRho, size_t nBinsTheta, float maxDepth,
           float unseenDecay, float focalLength);

  size_t nBinsRho() const { return nRho_; }
  size_t nBinsTheta() const { return nTheta_; }
  float& at(size_t iTheta, size_t iRho) { return map_[iTheta * nRho_ + iRho]; }
  float at(size_t iTheta, size_t iRho) const { return map_[iTheta * nRho_ + iRho]; }
  const std::vector<float>& data() const { return map_; }

  // bin math (depth_map.hpp:163-240, the "2" linear family)
  size_t getIRhoFromRho(float rho) const;
  int getIThetaFromTheta(float theta) const;   // adds theta_sight
  float getRhoFromIRho(size_t iRho) const;
  float getRho1FromIRho(size_t iRho) const;
  float getRho2FromIRho(size_t iRho) const;
  float getThetaFromITheta(size_t iTheta) const;
  float getTheta1FromITheta(size_t iTheta) const;
  float getTheta2FromITheta(size_t iTheta) const;

  // evidence update along the ray of image column x: bins nearer than the
  // observed depth lose evidence, the observed bin gains it (lambda = 0.9,
  // depth_map.cpp:36-44)
  void newPixel(float x, float y, float depth, float confidence,
                float wImg, float hImg);
  // re-bin the whole map under an ego translation (5x5 supersampling per
  // bin, depth_map.cpp:83-110) and update the sight direction
  void newDisplacement(const float* pos3, const float* sight3);
  // ingest the middle scanline of a depth+confidence image
  // (depth_map.cpp:112-124)
  void newFrame(const float* depth, const float* confidence, int w, int h);
  // steering: angle of the ray whose closest confident obstacle is nearest,
  // scanning fov bins around the sight; 0 if nothing closer than
  // nBinsRho/5 (depth_map.cpp:46-81)
  float getSafeTheta(size_t fov) const;
  // occupancy intensity rendered on a size x size top-down grid
  // (to2DMap, depth_map.cpp:126-143), values in [0, 1]
  void to2DMap(float* out, int size) const;

  std::string toString() const;
  float thetaSight() const { return theta_sight_; }

 private:
  float maxDepth_, focalLength_, unseenDecay_;
  size_t nRho_, nTheta_;
  std::vector<float> map_;
  float theta_sight_;
};

}  // namespace det

#endif
