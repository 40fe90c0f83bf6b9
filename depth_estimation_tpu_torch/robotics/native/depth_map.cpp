#include "depth_map.h"

#include <algorithm>
#include <cmath>
#include <sstream>

namespace det {

DepthMap::DepthMap(size_t nBinsRho, size_t nBinsTheta, float maxDepth,
                   float unseenDecay, float focalLength)
    : maxDepth_(maxDepth), focalLength_(focalLength),
      unseenDecay_(unseenDecay), nRho_(nBinsRho), nTheta_(nBinsTheta),
      map_(nBinsRho * nBinsTheta, 0.0f), theta_sight_(0.0f) {}

size_t DepthMap::getIRhoFromRho(float rho) const {
  if (rho > maxDepth_) return nRho_ - 1;
  long i = (long)std::floor(rho / maxDepth_ * (float)nRho_);
  return (size_t)std::max(0L, std::min((long)nRho_ - 1, i));
}

int DepthMap::getIThetaFromTheta(float theta) const {
  float tr = theta + theta_sight_;
  if (tr > PI) tr -= 2.0f * (float)PI;
  int i = (int)std::floor((tr / (2.0f * (float)PI) + 0.5f) * (float)nTheta_);
  // wrap (fixes the reference's out-of-range indexing)
  i %= (int)nTheta_;
  if (i < 0) i += (int)nTheta_;
  return i;
}

float DepthMap::getRho1FromIRho(size_t iRho) const {
  return maxDepth_ / (float)nRho_ * (float)iRho;
}
float DepthMap::getRho2FromIRho(size_t iRho) const {
  return maxDepth_ / (float)nRho_ * ((float)iRho + 1.0f);
}
float DepthMap::getRhoFromIRho(size_t iRho) const {
  return 0.5f * (getRho1FromIRho(iRho) + getRho2FromIRho(iRho));
}

float DepthMap::getTheta1FromITheta(size_t iTheta) const {
  float theta = ((float)iTheta / (float)nTheta_ - 0.5f) * 2.0f * (float)PI - theta_sight_;
  if (theta < -PI) return theta + 2.0f * (float)PI;
  return theta;
}
float DepthMap::getTheta2FromITheta(size_t iTheta) const {
  return getTheta1FromITheta(iTheta) + 2.0f * (float)PI / (float)nTheta_;
}
float DepthMap::getThetaFromITheta(size_t iTheta) const {
  return getTheta1FromITheta(iTheta) + (float)PI / (float)nTheta_;
}

void DepthMap::newPixel(float x, float /*y*/, float depth, float confidence,
                        float wImg, float /*hImg*/) {
  const float lambda = 0.9f;
  float theta = std::atan2(x - wImg / 2.0f, focalLength_);
  int iTheta = getIThetaFromTheta(theta);
  size_t iBin = getIRhoFromRho(depth);
  for (size_t i = 0; i < iBin; ++i) {
    float& v = at(iTheta, i);
    v = lambda * v + (1.0f - lambda) * (1.0f - confidence);
  }
  float& v = at(iTheta, iBin);
  v = lambda * v + (1.0f - lambda) * confidence;
}

void DepthMap::newDisplacement(const float* pos3, const float* sight3) {
  std::vector<float> next(nRho_ * nTheta_, 0.0f);
  const int nS = 5;  // 5x5 supersampling (depth_map.cpp:99)
  const float eps = 0.01f;
  for (size_t iTheta = 0; iTheta < nTheta_; ++iTheta) {
    for (size_t iRho = 0; iRho < nRho_; ++iRho) {
      float rho1 = getRho1FromIRho(iRho), rho2 = getRho2FromIRho(iRho);
      float th1 = getTheta1FromITheta(iTheta), th2 = getTheta2FromITheta(iTheta);
      float acc = 0.0f;
      for (int a = 0; a < nS; ++a) {
        for (int b = 0; b < nS; ++b) {
          float rho = rho1 + ((float)a + eps) / ((float)nS - 1.0f + 2 * eps) * (rho2 - rho1);
          float th = th1 + ((float)b + eps) / ((float)nS - 1.0f + 2 * eps) * (th2 - th1);
          float px = rho * std::cos(th) + pos3[0];
          float py = rho * std::sin(th) + pos3[1];
          float nrho = std::sqrt(px * px + py * py);
          float nth = std::atan2(py, px);
          acc += at(getIThetaFromTheta(nth), getIRhoFromRho(std::max(nrho, 1e-6f)));
        }
      }
      next[iTheta * nRho_ + iRho] = acc / (float)(nS * nS);
    }
  }
  map_.swap(next);
  float th = std::atan2(sight3[1], sight3[0]);
  if (th < 0.0f) th += 2.0f * (float)PI;
  theta_sight_ = th;
}

void DepthMap::newFrame(const float* depth, const float* confidence,
                        int w, int h) {
  int jmin = h / 2 - 1, jmax = h / 2;
  for (int j = jmin; j < jmax; ++j)
    for (int i = 0; i < w; ++i)
      if (confidence[j * w + i] > 0.5f)
        newPixel((float)i, (float)j, depth[j * w + i], 1.0f, (float)w, (float)h);
}

float DepthMap::getSafeTheta(size_t fov) const {
  float safeTheta = 0.0f;
  int steer = const_cast<DepthMap*>(this)->getIThetaFromTheta(theta_sight_);
  // NOTE: the reference recenters via getIThetaFromTheta(theta_sight),
  // which itself adds theta_sight — faithful reproduction.
  int ini = (int)std::floor((float)steer - (float)fov / 2.0f);
  int end = ini + (int)fov;
  size_t closestBin = nRho_ - 1;
  for (int iTheta = ini; iTheta < end; ++iTheta) {
    int it = ((iTheta % (int)nTheta_) + (int)nTheta_) % (int)nTheta_;
    float maxConf = 1e-1f;
    size_t maxBin = nRho_ - 1;
    for (size_t iRho = 0; iRho < nRho_; ++iRho) {
      float c = at(it, iRho);
      if (c > maxConf) {
        maxConf = c;
        maxBin = iRho;
      }
    }
    if (maxBin < closestBin) {
      closestBin = maxBin;
      safeTheta = -((float)iTheta / (float)(nTheta_ - 1) - 0.5f) * 2.0f * (float)PI;
    }
  }
  if (closestBin < nRho_ / 5) return safeTheta;
  return 0.0f;
}

void DepthMap::to2DMap(float* out, int size) const {
  float k = 2.0f * maxDepth_;
  for (int i = 0; i < size * size; ++i) out[i] = 0.0f;
  for (int i = 0; i < size; ++i) {
    for (int j = 0; j < size; ++j) {
      float x = ((float)i / (float)size - 0.5f) * k;
      float y = ((float)j / (float)size - 0.5f) * k;
      if (x == 0.0f && y == 0.0f) continue;
      float rho = std::sqrt(x * x + y * y);
      float th = std::atan2(y, x);
      float v = at(getIThetaFromTheta(th), getIRhoFromRho(rho));
      out[i * size + j] = std::max(out[i * size + j], v);
    }
  }
}

std::string DepthMap::toString() const {
  std::ostringstream oss;
  oss << "DepthMap " << nTheta_ << "x" << nRho_ << "\n";
  return oss.str();
}

}  // namespace det
