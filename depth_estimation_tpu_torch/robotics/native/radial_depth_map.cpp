#include "radial_depth_map.h"

#include <algorithm>
#include <cmath>

namespace det {

static const float kMaxVariance = 5.0f;

RadialDepthMap::RadialDepthMap(size_t nBinsTheta, float maxDepth,
                               float unseenDecay, float focalLength)
    : maxDepth_(maxDepth), focalLength_(focalLength),
      unseenDecay_(unseenDecay),
      depth_(nBinsTheta, maxDepth), var_(nBinsTheta, 1.0f),
      theta_sight_(0.0f) {}

int RadialDepthMap::getIThetaFromTheta(float theta) const {
  float tr = theta + theta_sight_;
  if (tr > PI) tr -= 2.0f * (float)PI;
  int i = (int)std::floor((tr / (2.0f * (float)PI) + 0.5f) * (float)nBinsTheta());
  i %= (int)nBinsTheta();
  if (i < 0) i += (int)nBinsTheta();
  return i;
}

float RadialDepthMap::getTheta1FromITheta(size_t iTheta) const {
  float theta = ((float)iTheta / (float)nBinsTheta() - 0.5f) * 2.0f * (float)PI - theta_sight_;
  if (theta < -PI) return theta + 2.0f * (float)PI;
  return theta;
}

float RadialDepthMap::getThetaFromITheta(size_t iTheta) const {
  return getTheta1FromITheta(iTheta) + (float)PI / (float)nBinsTheta();
}

void RadialDepthMap::newPixel(float x, float /*y*/, float depth,
                              float variance, float wImg, float /*hImg*/) {
  float theta = std::atan2(x - wImg / 2.0f, focalLength_);
  int i = getIThetaFromTheta(theta);
  float mapVar = var_[i];
  float K = variance / (variance + mapVar);
  depth_[i] = depth_[i] + K * (depth - depth_[i]);
  var_[i] = variance * mapVar / (variance + mapVar);
}

void RadialDepthMap::newDisplacement(const float* pos3, const float* sight3) {
  std::vector<float> nd = depth_;
  std::vector<float> nv = var_;
  for (size_t i = 0; i < nBinsTheta(); ++i) {
    float theta = getThetaFromITheta(i);
    float rho = depth_[i];
    float x = rho * std::cos(theta) - pos3[0];
    float y = rho * std::sin(theta) - pos3[1];
    float nrho = std::sqrt(x * x + y * y);
    float ntheta = std::atan2(y, x);
    if (ntheta < 0.0f) ntheta += 2.0f * (float)PI;
    int j = getIThetaFromTheta(ntheta);
    nd[j] = nrho;
    nv[j] = var_[i];
  }
  depth_.swap(nd);
  var_.swap(nv);
  float th = std::atan2(sight3[1], sight3[0]);
  if (th < 0.0f) th += 2.0f * (float)PI;
  theta_sight_ = th;
}

void RadialDepthMap::newFrame(const float* pixels, int w, int h) {
  int j = h / 2;
  for (int i = 0; i < w; ++i)
    newPixel((float)i, (float)j, pixels[j * w + i], 0.1f, (float)w, (float)h);
}

void RadialDepthMap::to2DMap(float* out, int size) const {
  for (int i = 0; i < size * size; ++i) out[i] = 0.0f;
  for (size_t it = 0; it < nBinsTheta(); ++it) {
    float theta = getThetaFromITheta(it);
    float rho = depth_[it];
    int x = (int)(rho * std::cos(theta)) + size / 2;
    int y = (int)(rho * std::sin(theta)) + size / 2;
    if (x > 0 && y > 0 && x < size && y < size)
      out[x * size + y] = 1.0f - var_[it] / kMaxVariance;
  }
}

}  // namespace det
