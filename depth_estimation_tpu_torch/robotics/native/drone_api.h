// Abstract drone contract — rebuild of the original ardrone/drone_api.h:
// per-step telemetry (depth/confidence maps, IMU and visual-odometry
// translations, Kalman-fused translation, gyro/sight, altitude, battery,
// state) plus control (takeoff/land/setControl). Matrices are plain float
// buffers (row-major), not cv::Mat — the runtime carries no OpenCV.
#ifndef DET_ROBOTICS_DRONE_API_H
#define DET_ROBOTICS_DRONE_API_H

#include <string>
#include <vector>

#include "common.h"

namespace det {

class DroneAPI {
 public:
  virtual ~DroneAPI() {}

  virtual void next() = 0;
  virtual float getDeltaT() const = 0;
  // depth/confidence maps: (h, w) row-major into out
  virtual void getDepthMap(float* out) const = 0;
  virtual void getConfidenceMap(float* out) const = 0;
  virtual int mapWidth() const = 0;
  virtual int mapHeight() const = 0;
  virtual Vec3 getIMUTranslation() = 0;
  virtual Vec3 getVisualOdometryTranslation() = 0;
  virtual Vec3 getFilteredTranslation() = 0;
  virtual Vec3 getIMUGyro() const = 0;
  virtual float getIMUAltitude() const = 0;
  virtual float getBatteryState() const = 0;
  virtual int getDroneState() const = 0;

  virtual void takeoff() = 0;
  virtual void land() = 0;
  virtual void setControl(float pitch, float gaz, float roll, float dyaw) = 0;

  virtual std::string toString() const = 0;
};

}  // namespace det

#endif
