// C API for ctypes bindings — the Python<->C++ boundary of the robotics
// runtime (the reference's equivalent boundary is the embedded-Lua tensor
// handoff, the original ardrone/ardrone_api.cpp:76-91; here it is a thin
// extern "C" surface over the native classes).
#include <cstring>

#include "depth_map.h"
#include "fifo_link.h"
#include "radial_depth_map.h"
#include "simulator.h"

using namespace det;

extern "C" {

// ---- SimulatedAPI ----------------------------------------------------

void* sim_create(int w, int h, float fixed_dt, unsigned long long seed,
                 int default_course) {
  return new SimulatedAPI(w, h, fixed_dt, seed, default_course != 0);
}
void sim_destroy(void* s) { delete (SimulatedAPI*)s; }
void sim_next(void* s) { ((SimulatedAPI*)s)->next(); }
float sim_delta_t(void* s) { return ((SimulatedAPI*)s)->getDeltaT(); }
void sim_depth_map(void* s, float* out) { ((SimulatedAPI*)s)->getDepthMap(out); }
void sim_confidence_map(void* s, float* out) { ((SimulatedAPI*)s)->getConfidenceMap(out); }
void sim_imu_translation(void* s, float* out3) {
  Vec3 v = ((SimulatedAPI*)s)->getIMUTranslation();
  out3[0] = v.x; out3[1] = v.y; out3[2] = v.z;
}
void sim_vo_translation(void* s, float* out3) {
  Vec3 v = ((SimulatedAPI*)s)->getVisualOdometryTranslation();
  out3[0] = v.x; out3[1] = v.y; out3[2] = v.z;
}
void sim_filtered_translation(void* s, float* out3) {
  Vec3 v = ((SimulatedAPI*)s)->getFilteredTranslation();
  out3[0] = v.x; out3[1] = v.y; out3[2] = v.z;
}
void sim_gyro(void* s, float* out3) {
  Vec3 v = ((SimulatedAPI*)s)->getIMUGyro();
  out3[0] = v.x; out3[1] = v.y; out3[2] = v.z;
}
float sim_altitude(void* s) { return ((SimulatedAPI*)s)->getIMUAltitude(); }
void sim_takeoff(void* s) { ((SimulatedAPI*)s)->takeoff(); }
void sim_land(void* s) { ((SimulatedAPI*)s)->land(); }
void sim_set_control(void* s, float pitch, float gaz, float roll, float dyaw) {
  ((SimulatedAPI*)s)->setControl(pitch, gaz, roll, dyaw);
}
void sim_position(void* s, float* out3) {
  Vec3 v = ((SimulatedAPI*)s)->position();
  out3[0] = v.x; out3[1] = v.y; out3[2] = v.z;
}
float sim_yaw(void* s) { return ((SimulatedAPI*)s)->yaw(); }
void sim_add_obstacle(void* s, float x, float y, float z, float r) {
  ((SimulatedAPI*)s)->addObstacle(x, y, z, r);
}
void sim_clear_obstacles(void* s) { ((SimulatedAPI*)s)->clearObstacles(); }

// ---- DepthMap ----------------------------------------------------------

void* dmap_create(size_t nRho, size_t nTheta, float maxDepth,
                  float unseenDecay, float focalLength) {
  return new DepthMap(nRho, nTheta, maxDepth, unseenDecay, focalLength);
}
void dmap_destroy(void* m) { delete (DepthMap*)m; }
void dmap_new_pixel(void* m, float x, float y, float depth, float conf,
                    float w, float h) {
  ((DepthMap*)m)->newPixel(x, y, depth, conf, w, h);
}
void dmap_new_displacement(void* m, const float* pos3, const float* sight3) {
  ((DepthMap*)m)->newDisplacement(pos3, sight3);
}
void dmap_new_frame(void* m, const float* depth, const float* conf,
                    int w, int h) {
  ((DepthMap*)m)->newFrame(depth, conf, w, h);
}
float dmap_safe_theta(void* m, size_t fov) {
  return ((DepthMap*)m)->getSafeTheta(fov);
}
void dmap_values(void* m, float* out) {
  const DepthMap* d = (DepthMap*)m;
  memcpy(out, d->data().data(), sizeof(float) * d->data().size());
}
void dmap_to_2d(void* m, float* out, int size) {
  ((DepthMap*)m)->to2DMap(out, size);
}
float dmap_theta_sight(void* m) { return ((DepthMap*)m)->thetaSight(); }

// ---- RadialDepthMap ------------------------------------------------------

void* rdmap_create(size_t nTheta, float maxDepth, float unseenDecay,
                   float focalLength) {
  return new RadialDepthMap(nTheta, maxDepth, unseenDecay, focalLength);
}
void rdmap_destroy(void* m) { delete (RadialDepthMap*)m; }
void rdmap_new_pixel(void* m, float x, float y, float depth, float var,
                     float w, float h) {
  ((RadialDepthMap*)m)->newPixel(x, y, depth, var, w, h);
}
void rdmap_new_displacement(void* m, const float* pos3, const float* sight3) {
  ((RadialDepthMap*)m)->newDisplacement(pos3, sight3);
}
void rdmap_new_frame(void* m, const float* pixels, int w, int h) {
  ((RadialDepthMap*)m)->newFrame(pixels, w, h);
}
void rdmap_depths(void* m, float* out) {
  const RadialDepthMap* d = (RadialDepthMap*)m;
  memcpy(out, d->depths().data(), sizeof(float) * d->nBinsTheta());
}
void rdmap_variances(void* m, float* out) {
  const RadialDepthMap* d = (RadialDepthMap*)m;
  memcpy(out, d->variances().data(), sizeof(float) * d->nBinsTheta());
}
void rdmap_to_2d(void* m, float* out, int size) {
  ((RadialDepthMap*)m)->to2DMap(out, size);
}

// ---- FIFO protocol ---------------------------------------------------------

void fifo_encode_control(char* buf33, float pitch, float gaz, float roll,
                         float yaw) {
  encodeControl(buf33, pitch, gaz, roll, yaw);
}
void fifo_encode_takeoff(char* buf33) { encodeTakeoff(buf33); }
void fifo_encode_land(char* buf33) { encodeLand(buf33); }
char fifo_decode_control(const char* buf33, float* pitch, float* gaz,
                         float* roll, float* yaw) {
  return decodeControl(buf33, pitch, gaz, roll, yaw);
}
void fifo_encode_navdata(char* buf98, int state, float battery,
                         const float* gyro3, float altitude,
                         const float* vel3) {
  Navdata nd;
  nd.droneState = state;
  nd.batteryState = battery;
  memcpy(nd.gyro, gyro3, 3 * sizeof(float));
  nd.altitude = altitude;
  memcpy(nd.velocity, vel3, 3 * sizeof(float));
  encodeNavdata(buf98, nd);
}
int fifo_decode_navdata(const char* buf98, int* state, float* battery,
                        float* gyro3, float* altitude, float* vel3) {
  Navdata nd;
  if (!decodeNavdata(buf98, &nd)) return 0;
  *state = nd.droneState;
  *battery = nd.batteryState;
  memcpy(gyro3, nd.gyro, 3 * sizeof(float));
  *altitude = nd.altitude;
  memcpy(vel3, nd.velocity, 3 * sizeof(float));
  return 1;
}

void* fifo_open(const char* control_path, const char* navdata_path) {
  return new FifoLink(control_path ? control_path : "",
                      navdata_path ? navdata_path : "");
}
void fifo_close(void* f) { delete (FifoLink*)f; }
void fifo_takeoff(void* f) { ((FifoLink*)f)->takeoff(); }
void fifo_land(void* f) { ((FifoLink*)f)->land(); }
void fifo_set_control(void* f, float pitch, float gaz, float roll, float yaw) {
  ((FifoLink*)f)->setControl(pitch, gaz, roll, yaw);
}
int fifo_read_navdata(void* f, int* state, float* battery, float* gyro3,
                      float* altitude, float* vel3) {
  Navdata nd;
  if (!((FifoLink*)f)->readNavdata(&nd)) return 0;
  *state = nd.droneState;
  *battery = nd.batteryState;
  memcpy(gyro3, nd.gyro, 3 * sizeof(float));
  *altitude = nd.altitude;
  memcpy(vel3, nd.velocity, 3 * sizeof(float));
  return 1;
}

}  // extern "C"
