// Hardware performance-counter reader for CPI collection.
//
// Native analog of the reference's one cgo component: the libpfm4 binding
// wrapping perf_event_open(2) to read per-cgroup cycles/instructions for the
// CPI metric (pkg/koordlet/util/perf_group/perf_group_linux.go:39-40,
// metricsadvisor performance collector :46-101). Instead of depending on
// libpfm4, this binds the two fixed architectural events directly via the raw
// syscall — no external library, same counters.
//
// Exposed as a C ABI consumed from Python via ctypes
// (koordinator_tpu_torch/native/perf.py), which builds it at first use into
// build/native/libkoordperf-<digest>.so (native/build.py). The port's copy
// of koordinator_tpu/native/perf_reader.cpp, the code unchanged.
//
// Usage pattern (mirrors the reference's perf group lifecycle):
//   handle = koordperf_open_group(target_fd, cpu, is_cgroup)
//     target_fd: an open fd of the cgroup directory (PERF_FLAG_PID_CGROUP) or
//                -1/0 for "this process" (pid = 0)
//   koordperf_read(handle, &cycles, &instructions)  // cumulative
//   koordperf_close(handle)

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <vector>

#if defined(__linux__)
#include <linux/perf_event.h>
#include <sys/ioctl.h>
#include <sys/syscall.h>
#include <unistd.h>
#endif

extern "C" {

struct KoordPerfGroup {
  int leader_fd;   // cycles (group leader)
  int member_fd;   // instructions
};

#if defined(__linux__)

static long perf_event_open_sys(struct perf_event_attr *attr, pid_t pid,
                                int cpu, int group_fd, unsigned long flags) {
  return syscall(SYS_perf_event_open, attr, pid, cpu, group_fd, flags);
}

static int open_counter(uint64_t config, pid_t pid, int cpu, int group_fd,
                        unsigned long flags) {
  struct perf_event_attr attr;
  memset(&attr, 0, sizeof(attr));
  attr.type = PERF_TYPE_HARDWARE;
  attr.size = sizeof(attr);
  attr.config = config;
  attr.disabled = (group_fd == -1) ? 1 : 0;  // leader starts disabled
  attr.inherit = 1;
  attr.read_format = PERF_FORMAT_GROUP;
  attr.exclude_kernel = 0;
  attr.exclude_hv = 1;
  return (int)perf_event_open_sys(&attr, pid, cpu, group_fd, flags);
}

// Returns an opaque handle (>0) or -errno on failure.
long koordperf_open_group(int target_fd, int cpu, int is_cgroup) {
  pid_t pid = 0;
  unsigned long flags = 0;
  if (is_cgroup) {
    pid = target_fd;  // cgroup fd goes in the pid slot
    flags = PERF_FLAG_PID_CGROUP;
  }
  int leader =
      open_counter(PERF_COUNT_HW_CPU_CYCLES, pid, cpu, -1, flags);
  if (leader < 0) return -(long)errno;
  int member =
      open_counter(PERF_COUNT_HW_INSTRUCTIONS, pid, cpu, leader, flags);
  if (member < 0) {
    long err = -(long)errno;
    close(leader);
    return err;
  }
  ioctl(leader, PERF_EVENT_IOC_RESET, PERF_IOC_FLAG_GROUP);
  ioctl(leader, PERF_EVENT_IOC_ENABLE, PERF_IOC_FLAG_GROUP);
  KoordPerfGroup *g = new KoordPerfGroup{leader, member};
  return (long)(intptr_t)g;
}

// PERF_FORMAT_GROUP layout: u64 nr; { u64 value; } cntr[nr];
int koordperf_read(long handle, uint64_t *cycles, uint64_t *instructions) {
  if (handle <= 0) return -EINVAL;
  KoordPerfGroup *g = (KoordPerfGroup *)(intptr_t)handle;
  uint64_t buf[1 + 2];
  ssize_t n = read(g->leader_fd, buf, sizeof(buf));
  if (n < (ssize_t)sizeof(uint64_t)) return -errno;
  uint64_t nr = buf[0];
  *cycles = nr >= 1 ? buf[1] : 0;
  *instructions = nr >= 2 ? buf[2] : 0;
  return 0;
}

void koordperf_close(long handle) {
  if (handle <= 0) return;
  KoordPerfGroup *g = (KoordPerfGroup *)(intptr_t)handle;
  ioctl(g->leader_fd, PERF_EVENT_IOC_DISABLE, PERF_IOC_FLAG_GROUP);
  close(g->member_fd);
  close(g->leader_fd);
  delete g;
}

#else  // non-linux stub

long koordperf_open_group(int, int, int) { return -38 /* ENOSYS */; }
int koordperf_read(long, uint64_t *, uint64_t *) { return -38; }
void koordperf_close(long) {}

#endif

}  // extern "C"
