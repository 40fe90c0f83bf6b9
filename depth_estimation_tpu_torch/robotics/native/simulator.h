// Kinematic drone simulator + synthetic depth renderer — the hardware-free
// fake backend. Rebuild of the original ardrone/simulator.{h,cpp}:
// friction + control accelerations, yaw integration, sphere-obstacle depth
// render, gaussian-noised IMU (sigma 0.2) / visual odometry (sigma 0.1),
// and the variance-weighted (Kalman-style) fused translation.
#ifndef DET_ROBOTICS_SIMULATOR_H
#define DET_ROBOTICS_SIMULATOR_H

#include <vector>

#include "drone_api.h"

namespace det {

class SimulatedAPI : public DroneAPI {
 public:
  struct Obstacle {
    Vec3 center;
    float radius;
    Obstacle(float x, float y, float z, float r) : center(x, y, z), radius(r) {}
  };

  // fixed_dt > 0 makes stepping deterministic (the reference uses wall
  // clock; tests need reproducibility). default obstacle course as in the
  // reference ctor (simulator.cpp:17-24).
  SimulatedAPI(int depthMapWidth = 320, int depthMapHeight = 240,
               float fixed_dt = 0.0f, uint64_t seed = 42,
               bool default_course = true);

  void next() override;
  float getDeltaT() const override { return delta_t; }
  void getDepthMap(float* out) const override;
  void getConfidenceMap(float* out) const override;
  int mapWidth() const override { return dmW; }
  int mapHeight() const override { return dmH; }
  Vec3 getIMUTranslation() override;
  Vec3 getVisualOdometryTranslation() override;
  Vec3 getFilteredTranslation() override;
  Vec3 getIMUGyro() const override { return pray(); }
  float getIMUAltitude() const override { return x.z; }
  float getBatteryState() const override { return 100.0f; }
  int getDroneState() const override { return 1; }
  float getIMUVariance() const { return 1.0f; }
  float getVisualOdometryVariance() const { return 1.0f; }

  void takeoff() override { flying = true; }
  void land() override { flying = false; }
  void setControl(float pitch, float gaz, float roll, float dyaw) override;

  std::string toString() const override;

  void addObstacle(float x, float y, float z, float r) {
    obstacles.push_back(Obstacle(x, y, z, r));
  }
  void clearObstacles() { obstacles.clear(); }

  Vec3 position() const { return x; }
  float yaw() const { return theta; }

 private:
  void updatePosition(float dt);
  Vec3 pray() const;   // forward sight ray
  Vec3 npray() const;  // left-normal ray
  Vec3 up() const { return Vec3(0, 0, 1); }

  double last_time;
  float delta_t, fixed_dt;
  bool flying;
  float theta, dtheta;
  Vec3 x, dx, ddx;
  float pitch, gaz, roll, dyaw;
  int dmW, dmH;
  float alpha_friction, focal_length;
  std::vector<Obstacle> obstacles;
  mutable Rng rng;
};

}  // namespace det

#endif
