// Drone FIFO protocol — the link to the (patched) Parrot SDK process.
// Rebuild of the original ardrone/ardrone_api.cpp:15-73,211-230 and the
// SDK side (gui.c:8-52, navdata.c:21-46): fixed-size atomic records over two
// named pipes — 33-byte control commands ('T' takeoff, 'L' land,
// "C%08d%08d%08d%08d" roll/pitch/gaz/yaw in [-100, 100]) and 98-byte
// space-padded navdata records
// "%d %d %d %d %d %d %f %f %f" = state battery gx gy gz altitude vx vy vz.
#ifndef DET_ROBOTICS_FIFO_LINK_H
#define DET_ROBOTICS_FIFO_LINK_H

#include <string>

namespace det {

const size_t kControlRecordLen = 33;
const size_t kNavdataRecordLen = 98;

struct Navdata {
  int droneState = 0;
  float batteryState = 100.0f;
  float gyro[3] = {0, 0, 0};
  float altitude = 0.0f;
  float velocity[3] = {0, 0, 0};
};

// encode into a kControlRecordLen buffer (space padded, no NUL terminator
// on the wire)
void encodeTakeoff(char* buf);
void encodeLand(char* buf);
void encodeControl(char* buf, float pitch, float gaz, float roll, float yaw);
// parse a control record; returns 'T', 'L' or 'C' (0 on garbage)
char decodeControl(const char* buf, float* pitch, float* gaz, float* roll,
                   float* yaw);

void encodeNavdata(char* buf, const Navdata& nd);
bool decodeNavdata(const char* buf, Navdata* nd);

class FifoLink {
 public:
  // opens control for writing and navdata for reading (blocking), like
  // ARdroneAPI's ctor; pass empty strings to skip either side
  FifoLink(const std::string& control_path, const std::string& navdata_path);
  ~FifoLink();
  bool ok() const { return control_fd_ >= 0 || navdata_fd_ >= 0; }

  void takeoff();
  void land();
  void setControl(float pitch, float gaz, float roll, float yaw);
  // drain all pending navdata records, keep the last (returns false if none)
  bool readNavdata(Navdata* nd);

 private:
  int control_fd_, navdata_fd_;
};

}  // namespace det

#endif
