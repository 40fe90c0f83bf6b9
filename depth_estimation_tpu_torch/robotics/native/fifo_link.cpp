#include "fifo_link.h"

#include <cstdio>
#include <cstring>
#include <fcntl.h>
#include <unistd.h>

#include "common.h"

namespace det {

void encodeTakeoff(char* buf) {
  memset(buf, ' ', kControlRecordLen);
  buf[0] = 'T';
}

void encodeLand(char* buf) {
  memset(buf, ' ', kControlRecordLen);
  buf[0] = 'L';
}

void encodeControl(char* buf, float pitch, float gaz, float roll, float yaw) {
  memset(buf, ' ', kControlRecordLen);
  // the reference casts the scaled floats through (char) — i.e. truncation
  // to [-128, 127]; values are saturated to [-100, 100] first
  // (ardrone_api.cpp:221-227)
  int r = (int)(char)(saturate(roll, -1.0f, 1.0f) * 100.0f);
  int p = (int)(char)(saturate(pitch, -1.0f, 1.0f) * 100.0f);
  int g = (int)(char)(saturate(gaz, -1.0f, 1.0f) * 100.0f);
  int y = (int)(char)(saturate(yaw, -1.0f, 1.0f) * 100.0f);
  char tmp[64];
  snprintf(tmp, sizeof(tmp), "C%08d%08d%08d%08d", r, p, g, y);
  memcpy(buf, tmp, strlen(tmp));
}

char decodeControl(const char* buf, float* pitch, float* gaz, float* roll,
                   float* yaw) {
  if (buf[0] == 'T' || buf[0] == 'L') return buf[0];
  if (buf[0] == 'C') {
    int r, p, g, y;
    if (sscanf(buf, "C%8d%8d%8d%8d", &r, &p, &g, &y) == 4) {
      *roll = r / 100.0f;
      *pitch = p / 100.0f;
      *gaz = g / 100.0f;
      *yaw = y / 100.0f;
      return 'C';
    }
  }
  return 0;
}

void encodeNavdata(char* buf, const Navdata& nd) {
  memset(buf, ' ', kNavdataRecordLen);
  char tmp[kNavdataRecordLen + 1];
  snprintf(tmp, sizeof(tmp), "%d %d %d %d %d %d %f %f %f",
           nd.droneState, (int)nd.batteryState,
           (int)nd.gyro[0], (int)nd.gyro[1], (int)nd.gyro[2],
           (int)nd.altitude,
           nd.velocity[0], nd.velocity[1], nd.velocity[2]);
  memcpy(buf, tmp, strlen(tmp));
}

bool decodeNavdata(const char* buf, Navdata* nd) {
  int bs, gx, gy, gz, a;
  float vx, vy, vz;
  if (sscanf(buf, "%d %d %d %d %d %d %f %f %f", &nd->droneState, &bs,
             &gx, &gy, &gz, &a, &vx, &vy, &vz) != 9)
    return false;
  nd->batteryState = (float)bs;
  nd->gyro[0] = (float)gx;
  nd->gyro[1] = (float)gy;
  nd->gyro[2] = (float)gz;
  nd->altitude = (float)a;
  nd->velocity[0] = vx;
  nd->velocity[1] = vy;
  nd->velocity[2] = vz;
  return true;
}

FifoLink::FifoLink(const std::string& control_path,
                   const std::string& navdata_path)
    : control_fd_(-1), navdata_fd_(-1) {
  if (!control_path.empty())
    control_fd_ = open(control_path.c_str(), O_WRONLY);
  if (!navdata_path.empty()) {
    // same double-open trick as the reference (first O_NDELAY to avoid
    // blocking forever when the peer isn't up, ardrone_api.cpp:26-28)
    navdata_fd_ = open(navdata_path.c_str(), O_RDONLY | O_NDELAY);
  }
}

FifoLink::~FifoLink() {
  if (control_fd_ >= 0) close(control_fd_);
  if (navdata_fd_ >= 0) close(navdata_fd_);
}

void FifoLink::takeoff() {
  char buf[kControlRecordLen];
  encodeTakeoff(buf);
  if (control_fd_ >= 0) (void)!write(control_fd_, buf, kControlRecordLen);
}

void FifoLink::land() {
  char buf[kControlRecordLen];
  encodeLand(buf);
  if (control_fd_ >= 0) (void)!write(control_fd_, buf, kControlRecordLen);
}

void FifoLink::setControl(float pitch, float gaz, float roll, float yaw) {
  char buf[kControlRecordLen];
  encodeControl(buf, pitch, gaz, roll, yaw);
  if (control_fd_ >= 0) (void)!write(control_fd_, buf, kControlRecordLen);
}

bool FifoLink::readNavdata(Navdata* nd) {
  if (navdata_fd_ < 0) return false;
  char buf[kNavdataRecordLen + 1];
  buf[kNavdataRecordLen] = 0;
  bool got = false;
  while (read(navdata_fd_, buf, kNavdataRecordLen) == (ssize_t)kNavdataRecordLen)
    got = decodeNavdata(buf, nd) || got;
  return got;
}

}  // namespace det
