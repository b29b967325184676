// sysmon: low-overhead native system sampler for sofa_tpu_torch.
//
// Upstream SOFA samples /proc/stat, /proc/diskstats, /sys net counters and
// /proc/cpuinfo from four Python daemon threads at sys_mon_rate Hz
// (bin/sofa_record.py).  Those threads live inside the profiler process
// (inside the profiled program itself under sofa_tpu_torch.api.profile())
// and cost a Python interpreter wakeup per sample; this native daemon
// replaces all four with one process whose steady state is a read()+sscanf
// loop, keeping the profiler's own footprint out of the measurement.
//
// Usage: sysmon <logdir> <rate_hz> [iface]
//
// Writes (append) until SIGTERM/SIGINT, or until its parent (the recorder,
// or the program that runs sofa_tpu_torch.api.profile()) is gone, so that a
// killed parent never leaves a sampler behind:
//   logdir/mpstat.txt   "<ts> cpu<id|all> user nice sys idle iowait irq softirq steal"
//   logdir/diskstat.txt "<ts> <dev> rd_ios rd_sec rd_ms wr_ios wr_sec wr_ms io_inflight"
//   logdir/netstat.txt  "<ts> <iface> rx_bytes tx_bytes rx_pkts tx_pkts"
//   logdir/cpuinfo.txt  "<ts> <mhz_core0> <mhz_core1> ..."
// Timestamps are CLOCK_REALTIME seconds with 6 decimals; formats are shared
// with the pure-Python fallback sampler (sofa_tpu_torch/collectors/procmon.py)
// so the ingest parser (sofa_tpu_torch/ingest/procfs.py) handles both
// identically.

#include <csignal>
#include <cstdlib>
#include <cstdio>
#include <cstring>
#include <ctime>
#include <string>
#include <unistd.h>
#include <vector>

static volatile sig_atomic_t g_stop = 0;
static void on_signal(int) { g_stop = 1; }

static double now_s() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return ts.tv_sec + ts.tv_nsec / 1e9;
}

// Read a whole (small) file into buf; returns length or -1.
static int slurp(const char* path, char* buf, int cap) {
  FILE* f = fopen(path, "r");
  if (!f) return -1;
  int n = fread(buf, 1, cap - 1, f);
  fclose(f);
  if (n < 0) n = 0;
  buf[n] = 0;
  return n;
}

static void sample_proc_stat(FILE* out, double ts, char* buf, int cap) {
  if (slurp("/proc/stat", buf, cap) <= 0) return;
  for (char* line = strtok(buf, "\n"); line; line = strtok(nullptr, "\n")) {
    if (strncmp(line, "cpu", 3) != 0) break;  // cpu lines lead the file
    char name[32];
    unsigned long long u, n, s, i, io, irq, sirq, st;
    u = n = s = i = io = irq = sirq = st = 0;
    int got = sscanf(line, "%31s %llu %llu %llu %llu %llu %llu %llu %llu",
                     name, &u, &n, &s, &i, &io, &irq, &sirq, &st);
    if (got < 5) continue;
    const char* id = (strcmp(name, "cpu") == 0) ? "cpuall" : name;
    fprintf(out, "%.6f %s %llu %llu %llu %llu %llu %llu %llu %llu\n",
            ts, id, u, n, s, i, io, irq, sirq, st);
  }
}

static void sample_diskstats(FILE* out, double ts, char* buf, int cap) {
  if (slurp("/proc/diskstats", buf, cap) <= 0) return;
  for (char* line = strtok(buf, "\n"); line; line = strtok(nullptr, "\n")) {
    int major, minor;
    char dev[64];
    unsigned long long rd_ios, rd_merges, rd_sec, rd_ms;
    unsigned long long wr_ios, wr_merges, wr_sec, wr_ms;
    unsigned long long inflight;
    int got = sscanf(line,
                     "%d %d %63s %llu %llu %llu %llu %llu %llu %llu %llu %llu",
                     &major, &minor, dev, &rd_ios, &rd_merges, &rd_sec, &rd_ms,
                     &wr_ios, &wr_merges, &wr_sec, &wr_ms, &inflight);
    if (got < 12) continue;
    // Skip loopbacks and ram disks: all-zero rows that upstream SOFA's
    // preprocess drops anyway.
    if (strncmp(dev, "loop", 4) == 0 || strncmp(dev, "ram", 3) == 0) continue;
    fprintf(out, "%.6f %s %llu %llu %llu %llu %llu %llu %llu\n", ts, dev,
            rd_ios, rd_sec, rd_ms, wr_ios, wr_sec, wr_ms, inflight);
  }
}

static void sample_net(FILE* out, double ts, char* buf, int cap,
                       const std::string& iface_filter) {
  // /proc/net/dev has every interface in one file: one read instead of
  // upstream SOFA's per-file /sys/class/net reads.
  if (slurp("/proc/net/dev", buf, cap) <= 0) return;
  for (char* line = strtok(buf, "\n"); line; line = strtok(nullptr, "\n")) {
    char* colon = strchr(line, ':');
    if (!colon) continue;
    *colon = ' ';
    char iface[64];
    unsigned long long rxb, rxp, d1, d2, d3, d4, d5, d6, txb, txp;
    int got = sscanf(line, "%63s %llu %llu %llu %llu %llu %llu %llu %llu %llu %llu",
                     iface, &rxb, &rxp, &d1, &d2, &d3, &d4, &d5, &d6, &txb, &txp);
    if (got < 11) continue;
    if (strcmp(iface, "lo") == 0) continue;
    if (!iface_filter.empty() && iface_filter != iface) continue;
    fprintf(out, "%.6f %s %llu %llu %llu %llu\n", ts, iface, rxb, txb, rxp, txp);
  }
}

static void sample_cpuinfo(FILE* out, double ts, char* buf, int cap) {
  if (slurp("/proc/cpuinfo", buf, cap) <= 0) return;
  fprintf(out, "%.6f", ts);
  bool any = false;
  for (char* line = strtok(buf, "\n"); line; line = strtok(nullptr, "\n")) {
    double mhz;
    if (sscanf(line, "cpu MHz : %lf", &mhz) == 1 ||
        sscanf(line, "cpu MHz\t\t: %lf", &mhz) == 1) {
      fprintf(out, " %.3f", mhz);
      any = true;
    }
  }
  if (!any) fprintf(out, " 0");  // VMs often hide MHz; keep the row shape
  fprintf(out, "\n");
}

int main(int argc, char** argv) {
  if (argc < 3) {
    fprintf(stderr, "usage: sysmon <logdir> <rate_hz> [iface]\n");
    return 2;
  }
  std::string logdir = argv[1];
  double rate = atof(argv[2]);
  if (rate <= 0) rate = 10.0;
  std::string iface = argc > 3 ? argv[3] : "";
  if (!logdir.empty() && logdir.back() != '/') logdir += '/';

  const pid_t parent = getppid();
  signal(SIGTERM, on_signal);
  signal(SIGINT, on_signal);

  FILE* f_mp = fopen((logdir + "mpstat.txt").c_str(), "a");
  FILE* f_dk = fopen((logdir + "diskstat.txt").c_str(), "a");
  FILE* f_nt = fopen((logdir + "netstat.txt").c_str(), "a");
  FILE* f_ci = fopen((logdir + "cpuinfo.txt").c_str(), "a");
  if (!f_mp || !f_dk || !f_nt || !f_ci) {
    fprintf(stderr, "sysmon: cannot open output files in %s\n", logdir.c_str());
    return 1;
  }

  static char buf[1 << 20];
  const long interval_ns = static_cast<long>(1e9 / rate);
  while (!g_stop && getppid() == parent) {
    double ts = now_s();
    sample_proc_stat(f_mp, ts, buf, sizeof(buf));
    sample_diskstats(f_dk, ts, buf, sizeof(buf));
    sample_net(f_nt, ts, buf, sizeof(buf), iface);
    sample_cpuinfo(f_ci, ts, buf, sizeof(buf));
    fflush(f_mp); fflush(f_dk); fflush(f_nt); fflush(f_ci);
    struct timespec req = {interval_ns / 1000000000L, interval_ns % 1000000000L};
    nanosleep(&req, nullptr);
  }
  fclose(f_mp); fclose(f_dk); fclose(f_nt); fclose(f_ci);
  return 0;
}
