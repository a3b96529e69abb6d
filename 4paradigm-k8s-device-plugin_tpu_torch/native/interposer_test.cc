/* interposer_test.cc — scenarios of libvtpu_cuda.so against the mock
 * driver (mock_cuda.cc), the port's counterpart of vtpu's
 * native/tests/interposer_test.cc.
 *
 *   LD_PRELOAD=libvtpu_cuda.so LD_LIBRARY_PATH=<dir of the mocks' sonames> \
 *     interposer_test [scenario]
 *
 * With a scenario name it runs that scenario and exits 0 when it holds
 * (`killer` must die of SIGKILL instead).  Without one it runs every
 * scenario, each in a fresh process (the quota env is read once, at the
 * first hooked call).  This program reaches the driver API the way the CUDA
 * runtime does: dlopen libcuda.so.1, dlsym its cuGetProcAddress_v2, and
 * everything else through that.  tests/test_torch_interposer.py runs each
 * scenario as its own case.
 */
#include <dlfcn.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <sys/wait.h>
#include <fcntl.h>
#include <errno.h>
#include <pthread.h>
#include <time.h>
#include <unistd.h>

#include <atomic>
#include <string>

#include "cuda_abi.h"
#include "vtpu_core.h"

using namespace vtpu_abi;

#define CHECK(cond)                                                       \
  do {                                                                    \
    if (!(cond)) {                                                        \
      fprintf(stderr, "CHECK failed %s:%d: %s\n", __FILE__, __LINE__,     \
              #cond);                                                     \
      exit(1);                                                            \
    }                                                                     \
  } while (0)

static double mono_s() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return ts.tv_sec + ts.tv_nsec * 1e-9;
}

/* Mirror of the interposer's vtpu_cuda_stats. */
struct Stats {
  uint64_t launches, graph_launches, gate_waits, gate_ns, wait_ns, refused,
      charged_bytes, spilled_bytes, booked_us, debited_us, busy_ticks,
      shared_ticks, procaddr_hooks;
  int32_t state, meter, ndev, core_pct, policy, priority, oversubscribe,
      oom_killer;
  uint64_t min_cost_us;
  uint64_t limits[16];
};

static Stats stats() {
  auto* f = (int (*)(Stats*, size_t))dlsym(RTLD_DEFAULT,
                                           "vtpu_cuda_interposer_stats");
  CHECK(f != nullptr);
  Stats s;
  CHECK(f(&s, sizeof(s)) == 0);
  return s;
}

/* ---- the driver API, fetched as the CUDA runtime fetches it ----------- */

static void* g_cuda = nullptr;
static fn_cuGetProcAddress_v2* gpa = nullptr;

static void* proc(const char* name, int version = 12080,
                  cuuint64_t flags = CU_GET_PROC_ADDRESS_DEFAULT) {
  void* p = nullptr;
  CUdriverProcAddressQueryResult st = CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
  CHECK(gpa(name, &p, version, flags, &st) == CUDA_SUCCESS);
  CHECK(st == CU_GET_PROC_ADDRESS_SUCCESS && p != nullptr);
  return p;
}

template <class F>
static F* mock(const char* name) {
  F* f = (F*)dlsym(g_cuda, name);
  CHECK(f != nullptr);
  return f;
}

static void open_driver() {
  g_cuda = dlopen("libcuda.so.1", RTLD_NOW | RTLD_LOCAL);
  CHECK(g_cuda != nullptr);
  gpa = (fn_cuGetProcAddress_v2*)dlsym(g_cuda, "cuGetProcAddress_v2");
  CHECK(gpa != nullptr);
  CHECK(((fn_cuInit*)proc("cuInit"))(0) == CUDA_SUCCESS);
}

static void set_device(int dev) {
  auto* set = (CUresult(*)(CUcontext))proc("cuCtxSetCurrent");
  CHECK(set((CUcontext)(uintptr_t)(dev + 1)) == CUDA_SUCCESS);
}

static CUdeviceptr alloc(size_t bytes, CUresult want = CUDA_SUCCESS) {
  CUdeviceptr p = 0;
  CHECK(((fn_cuMemAlloc_v2*)proc("cuMemAlloc", 3020))(&p, bytes) == want);
  return p;
}

static void release(CUdeviceptr p) {
  CHECK(((fn_cuMemFree_v2*)proc("cuMemFree", 3020))(p) == CUDA_SUCCESS);
}

static void mem_info(size_t* freeb, size_t* total) {
  CHECK(((fn_cuMemGetInfo_v2*)proc("cuMemGetInfo", 3020))(freeb, total) ==
        CUDA_SUCCESS);
}

/* A launch on stream 0: the legacy default stream, or with `per_thread`
 * through cuLaunchKernel_ptsz, the calling thread's per-thread default
 * stream (as a program built with --default-stream per-thread does). */
static CUresult launch(bool per_thread = false) {
  auto* f = (fn_cuLaunchKernel*)proc(
      "cuLaunchKernel", 12080,
      per_thread ? CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM
                 : CU_GET_PROC_ADDRESS_DEFAULT);
  return f(nullptr, 1, 1, 1, 32, 1, 1, 0, nullptr, nullptr, nullptr);
}

static void synchronize() {
  CHECK(((CUresult(*)())proc("cuCtxSynchronize"))() == CUDA_SUCCESS);
}

static const size_t Ki = 1024, Mi = 1024 * 1024;

/* ---- scenarios ------------------------------------------------------ */

static int sc_mem() {
  setenv("MOCK_CUDA_DEVICES", "2", 1);
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  setenv("VTPU_DEVICE_HBM_LIMIT_1", "2Mi", 1);
  open_driver();
  auto* real_allocs = mock<uint64_t(const char*)>("mockCalls");
  set_device(0);
  CUdeviceptr b1 = alloc(128 * Ki);
  /* Past the 1 MiB cap: refused before the real allocator runs. */
  uint64_t calls = real_allocs("cuMemAlloc_v2");
  alloc(2 * Mi, CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(real_allocs("cuMemAlloc_v2") == calls);
  CHECK(stats().refused == 1);
  /* The same size fits device 1's 2 MiB cap. */
  set_device(1);
  CUdeviceptr b2 = alloc(1600 * Ki);
  size_t total = 0;
  CHECK(((fn_cuDeviceTotalMem_v2*)proc("cuDeviceTotalMem", 3020))(
            &total, 1) == CUDA_SUCCESS);
  CHECK(total == 2 * Mi);
  release(b2);
  set_device(0);
  size_t freeb = 0;
  mem_info(&freeb, &total);
  CHECK(total == 1 * Mi && freeb == 1 * Mi - 128 * Ki);
  release(b1);
  CUdeviceptr b3 = alloc(900 * Ki);
  CHECK(stats().charged_bytes == 900 * Ki);
  release(b3);
  /* Pitch is charged at the padded size the driver chose. */
  CUdeviceptr p = 0;
  size_t pitch = 0;
  CHECK(((fn_cuMemAllocPitch_v2*)proc("cuMemAllocPitch", 3020))(
            &p, &pitch, 1000, 100, 4) == CUDA_SUCCESS);
  CHECK(pitch == 1024 && stats().charged_bytes == 1024 * 100);
  release(p);
  /* Stream-ordered, pooled and managed allocations are charged too. */
  CUdeviceptr a = 0, q = 0, m = 0;
  CHECK(((fn_cuMemAllocAsync*)proc("cuMemAllocAsync"))(&a, 256 * Ki,
                                                      nullptr) ==
        CUDA_SUCCESS);
  CHECK(((fn_cuMemAllocFromPoolAsync*)proc("cuMemAllocFromPoolAsync"))(
            &q, 256 * Ki, nullptr, nullptr) == CUDA_SUCCESS);
  CHECK(((fn_cuMemAllocManaged*)proc("cuMemAllocManaged"))(
            &m, 256 * Ki, CU_MEM_ATTACH_GLOBAL) == CUDA_SUCCESS);
  CHECK(stats().charged_bytes == 768 * Ki);
  CHECK(((fn_cuMemAllocAsync*)proc("cuMemAllocAsync"))(&p, 512 * Ki,
                                                      nullptr) ==
        CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(((fn_cuMemFreeAsync*)proc("cuMemFreeAsync"))(a, nullptr) ==
        CUDA_SUCCESS);
  CHECK(((fn_cuMemFreeAsync*)proc("cuMemFreeAsync"))(q, nullptr) ==
        CUDA_SUCCESS);
  release(m);
  CHECK(stats().charged_bytes == 0);
  mem_info(&freeb, &total);
  CHECK(freeb == 1 * Mi);
  printf("mem: per-device caps, refusals before allocation, pitch/async/"
         "pool/managed charged and released\n");
  return 0;
}

/* Launch-and-synchronise loop for `seconds`; returns the launches made. */
static int busy_loop(double seconds, bool synchronise = true,
                     bool per_thread = false) {
  int n = 0;
  double t0 = mono_s();
  while (mono_s() - t0 < seconds) {
    CHECK(launch(per_thread) == CUDA_SUCCESS);
    if (synchronise) synchronize();
    n++;
  }
  return n;
}

/* Each kernel keeps the mock device busy 10 ms; the watcher sees the
 * stream busy and books it.  At 50% FORCE the loop converges to half the
 * card once the 400 ms burst is spent.  `per_thread`: every launch goes
 * to this thread's per-thread default stream, which the watcher's thread
 * cannot query. */
static int throttled(const char* name, bool per_thread) {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "50", 1);
  setenv("VTPU_CORE_UTILIZATION_POLICY", "FORCE", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  open_driver();
  busy_loop(1.2, true, per_thread);
  double t0 = mono_s();
  int n = busy_loop(1.5, true, per_thread);
  double duty = n * 0.010 / (mono_s() - t0);
  Stats s = stats();
  printf("%s: duty %.3f at a 50%% share (%d launches x 10 ms), %llu waits, "
         "%llu us booked, meter %d\n", name, duty, n,
         (unsigned long long)s.gate_waits, (unsigned long long)s.booked_us,
         s.meter);
  CHECK(s.meter == 1 && s.busy_ticks > 0 && s.debited_us > 0);
  CHECK(s.shared_ticks == 0);
  CHECK(s.gate_waits > 0);
  CHECK(duty > 0.30 && duty < 0.70);
  return 0;
}

static int sc_throttle() { return throttled("throttle", false); }

static int sc_ptsz_meter() {
  int rc = throttled("ptsz_meter", true);
  CHECK(mock<uint64_t(const char*)>("mockCalls")("cuLaunchKernel_ptsz") > 0);
  return rc;
}

/* One launch on this thread's per-thread default stream; with a barrier,
 * meet the others after it and again before exiting. */
static void* ptsz_launch(void* barrier) {
  CHECK(launch(true) == CUDA_SUCCESS);
  if (barrier) {
    pthread_barrier_wait((pthread_barrier_t*)barrier);
    pthread_barrier_wait((pthread_barrier_t*)barrier);
  }
  return nullptr;
}

/* Per-thread default streams take one event per (thread, context), reused
 * across context switches, and give it back when their thread exits; past
 * the slots, a launch is gated but makes no event. */
static int sc_ptsz_threads() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("MOCK_CUDA_DEVICES", "2", 1);
  open_driver();
  auto* calls = mock<uint64_t(const char*)>("mockCalls");
  auto live = [&] {
    return calls("cuEventCreate") - calls("cuEventDestroy_v2");
  };
  /* One thread alternating between two contexts. */
  for (int i = 0; i < 200; i++) {
    set_device(i % 2);
    CHECK(launch(true) == CUDA_SUCCESS);
  }
  CHECK(calls("cuEventCreate") == 2 && calls("cuEventRecord") == 200);
  set_device(0);
  /* 100 threads one after another: each gives its slot back. */
  for (int i = 0; i < 100; i++) {
    pthread_t t;
    CHECK(pthread_create(&t, nullptr, ptsz_launch, nullptr) == 0);
    CHECK(pthread_join(t, nullptr) == 0);
  }
  CHECK(calls("cuEventCreate") == 102 && live() == 2);
  /* 80 threads at once: the 62 slots left are taken, the other 18 threads
   * make no event. */
  const int k = 80;
  pthread_barrier_t barrier;
  pthread_barrier_init(&barrier, nullptr, k + 1);
  pthread_t ts[k];
  for (int i = 0; i < k; i++)
    CHECK(pthread_create(&ts[i], nullptr, ptsz_launch, &barrier) == 0);
  pthread_barrier_wait(&barrier);
  uint64_t during = live();
  pthread_barrier_wait(&barrier);
  for (int i = 0; i < k; i++) CHECK(pthread_join(ts[i], nullptr) == 0);
  pthread_barrier_destroy(&barrier);
  CHECK(during == 64 && live() == 2);
  /* The slots came back: a new thread's launches are metered again. */
  uint64_t records = calls("cuEventRecord");
  ptsz_launch(nullptr);  /* this thread: its slot in context 1 exists */
  pthread_t t;
  CHECK(pthread_create(&t, nullptr, ptsz_launch, nullptr) == 0);
  CHECK(pthread_join(t, nullptr) == 0);
  CHECK(calls("cuEventRecord") == records + 2 && live() == 2);
  printf("ptsz_threads: %llu events made, at most 64 live, 2 left\n",
         (unsigned long long)calls("cuEventCreate"));
  return 0;
}

static int sc_shared_region() {
  /* Two processes on one region at 50% FORCE, each keeping its (own) mock
   * device busy.  While both are busy each books half of every tick, as
   * the card would time-slice between them, so the pair's share lets
   * each run about half the time; billing each its whole busy time would
   * hold each to a quarter. */
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "50", 1);
  setenv("VTPU_CORE_UTILIZATION_POLICY", "FORCE", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  int fds[2];
  CHECK(pipe(fds) == 0);
  pid_t child = fork();
  CHECK(child >= 0);
  open_driver();
  busy_loop(1.2);
  double t0 = mono_s();
  int n = busy_loop(2.0);
  double duty[2] = {n * 0.010 / (mono_s() - t0), 0};
  Stats s = stats();
  if (child == 0) {
    double mine[2] = {duty[0], (double)s.shared_ticks};
    CHECK(write(fds[1], mine, sizeof(mine)) == (ssize_t)sizeof(mine));
    _exit(0);
  }
  double other[2] = {0, 0};
  CHECK(read(fds[0], other, sizeof(other)) == (ssize_t)sizeof(other));
  int st = 0;
  CHECK(waitpid(child, &st, 0) == child && WIFEXITED(st) &&
        WEXITSTATUS(st) == 0);
  duty[1] = other[0];
  printf("shared_region: duties %.3f + %.3f at one 50%% share, shared "
         "ticks %llu and %.0f\n", duty[0], duty[1],
         (unsigned long long)s.shared_ticks, other[1]);
  CHECK(s.shared_ticks > 0 && other[1] > 0);
  CHECK(duty[0] > 0.2 && duty[1] > 0.2);
  CHECK(duty[0] + duty[1] > 0.7 && duty[0] + duty[1] < 1.3);
  return 0;
}

static int sc_sole_fast() {
  /* DEFAULT policy: the sole process on the region runs ungated. */
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "50", 1);
  setenv("MOCK_KERNEL_US", "1000", 1);
  open_driver();
  double t0 = mono_s();
  for (int i = 0; i < 30; i++) {
    CHECK(launch() == CUDA_SUCCESS);
    synchronize();
  }
  double elapsed = mono_s() - t0;
  printf("sole_fast: %.3f s for 30 x 1 ms (DEFAULT policy)\n", elapsed);
  CHECK(elapsed < 0.12);
  CHECK(stats().gate_waits == 0);
  return 0;
}

static int sc_floor_zero_latency() {
  /* Kernels the watcher never sees busy (0 µs each): the per-launch floor
   * alone holds the 25% share. */
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "25", 1);
  setenv("VTPU_CORE_UTILIZATION_POLICY", "FORCE", 1);
  setenv("VTPU_MIN_EXEC_COST_US", "5000", 1);
  open_driver();
  for (int i = 0; i < 130; i++) CHECK(launch() == CUDA_SUCCESS);
  double t0 = mono_s();
  int n = busy_loop(1.0, false);
  double duty = n * 0.005 / (mono_s() - t0);
  printf("floor_zero_latency: duty %.3f (%d launches x 5 ms floor)\n", duty,
         n);
  CHECK(duty > 0.15 && duty < 0.40);
  return 0;
}

static int sc_spill() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  setenv("VTPU_OVERSUBSCRIBE", "true", 1);
  open_driver();
  CUdeviceptr big = alloc(2 * Mi);
  CHECK(mock<int(CUdeviceptr)>("mockIsManaged")(big));
  Stats s = stats();
  CHECK(s.spilled_bytes == 2 * Mi && s.charged_bytes == 0);
  size_t freeb = 0, total = 0;
  mem_info(&freeb, &total);
  CHECK(freeb == 1 * Mi && total == 1 * Mi);
  CUdeviceptr small = alloc(512 * Ki);
  CHECK(!mock<int(CUdeviceptr)>("mockIsManaged")(small));
  release(big);
  release(small);
  s = stats();
  CHECK(s.spilled_bytes == 0 && s.charged_bytes == 0);
  printf("spill: 2 MiB past a 1 MiB cap allocated managed, uncharged\n");
  return 0;
}

static int sc_killer() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  setenv("VTPU_ACTIVE_OOM_KILLER", "true", 1);
  open_driver();
  alloc(2 * Mi, CUDA_ERROR_OUT_OF_MEMORY);
  fprintf(stderr, "killer did not fire\n");
  return 1;
}

static int sc_procaddr() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  open_driver();
  auto* real = mock<void*(const char*)>("mockRealAddress");
  /* A base name at a version resolves to the versioned function, and its
   * wrapper comes back. */
  void* p = proc("cuMemAlloc", 3020);
  CHECK(p == dlsym(RTLD_DEFAULT, "cuMemAlloc_v2"));
  CHECK(p != real("cuMemAlloc_v2"));
  /* Before 3.2 the same base name is the unhooked 32-bit cuMemAlloc. */
  CHECK(proc("cuMemAlloc", 2000) == real("cuMemAlloc"));
  /* Per-thread default stream variants get their own wrappers. */
  void* ptsz = proc("cuLaunchKernel", 12080,
                    CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  CHECK(ptsz == dlsym(RTLD_DEFAULT, "cuLaunchKernel_ptsz"));
  CHECK(ptsz != proc("cuLaunchKernel"));
  uint64_t before = stats().launches;
  CHECK(((fn_cuLaunchKernel*)ptsz)(nullptr, 1, 1, 1, 1, 1, 1, 0, nullptr,
                                   nullptr, nullptr) == CUDA_SUCCESS);
  CHECK(stats().launches == before + 1);
  CHECK(mock<uint64_t(const char*)>("mockCalls")("cuLaunchKernel_ptsz") == 1);
  /* cuGetProcAddress itself comes back wrapped, at both versions. */
  CHECK(proc("cuGetProcAddress", 12000) ==
        dlsym(RTLD_DEFAULT, "cuGetProcAddress_v2"));
  CHECK(proc("cuGetProcAddress", 11030) ==
        dlsym(RTLD_DEFAULT, "cuGetProcAddress"));
  /* An unhooked entry point comes back untouched. */
  CHECK(proc("cuCtxSetCurrent") == real("cuCtxSetCurrent"));
  CHECK(proc("cuCtxSynchronize") == real("cuCtxSynchronize"));
  /* An unknown name fails as the driver says. */
  void* none = nullptr;
  CUdriverProcAddressQueryResult st = CU_GET_PROC_ADDRESS_SUCCESS;
  CHECK(gpa("cuNoSuchFunction", &none, 12080, 0, &st) ==
            CUDA_ERROR_NOT_FOUND &&
        none == nullptr && st == CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND);
  CHECK(stats().procaddr_hooks >= 5);
  printf("procaddr: versioned, _ptsz and self lookups wrapped; unhooked "
         "and legacy pointers untouched\n");
  return 0;
}

static int sc_meminfo_nvml() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  open_driver();
  CUdeviceptr p = alloc(256 * Ki);
  void* nvml = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL);
  CHECK(nvml != nullptr);
  auto* init = (fn_nvmlInit_v2*)dlsym(nvml, "nvmlInit_v2");
  auto* by_index = (fn_nvmlDeviceGetHandleByIndex_v2*)dlsym(
      nvml, "nvmlDeviceGetHandleByIndex_v2");
  auto* info = (fn_nvmlDeviceGetMemoryInfo*)dlsym(nvml,
                                                  "nvmlDeviceGetMemoryInfo");
  auto* info2 = (fn_nvmlDeviceGetMemoryInfo_v2*)dlsym(
      nvml, "nvmlDeviceGetMemoryInfo_v2");
  CHECK(init && by_index && info && info2);
  CHECK(info == dlsym(RTLD_DEFAULT, "nvmlDeviceGetMemoryInfo"));
  CHECK(init() == NVML_SUCCESS);
  nvmlDevice_t dev = nullptr;
  CHECK(by_index(0, &dev) == NVML_SUCCESS);
  nvmlMemory_t m;
  CHECK(info(dev, &m) == NVML_SUCCESS);
  CHECK(m.total == 1 * Mi && m.used == 256 * Ki && m.free == 768 * Ki);
  nvmlMemory_v2_t m2;
  memset(&m2, 0, sizeof(m2));
  m2.version = (unsigned int)(sizeof(m2) | (2 << 24));
  CHECK(info2(dev, &m2) == NVML_SUCCESS);
  CHECK(m2.total == 1 * Mi && m2.used == 256 * Ki && m2.free == 768 * Ki &&
        m2.reserved == 0);
  release(p);
  CHECK(info(dev, &m) == NVML_SUCCESS && m.used == 0 && m.free == 1 * Mi);
  printf("meminfo_nvml: NVML reports the 1 MiB cap and the region's use\n");
  return 0;
}

static int sc_array() {
  /* CUDA arrays are charged from their descriptors before the driver
   * allocates them, and released by their destroys; so are graph memory
   * nodes of a graph never instantiated, until the graph is destroyed. */
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  open_driver();
  auto* calls = mock<uint64_t(const char*)>("mockCalls");
  auto* create = (fn_cuArrayCreate_v2*)proc("cuArrayCreate", 3020);
  auto* create3d = (fn_cuArray3DCreate_v2*)proc("cuArray3DCreate", 3020);
  auto* mipmapped =
      (fn_cuMipmappedArrayCreate*)proc("cuMipmappedArrayCreate", 5000);
  auto* destroy = (fn_cuArrayDestroy*)proc("cuArrayDestroy");
  auto* destroy_mipmapped =
      (fn_cuMipmappedArrayDestroy*)proc("cuMipmappedArrayDestroy", 5000);
  /* 256 x 128 float4: 512 KiB. */
  CUDA_ARRAY_DESCRIPTOR d2 = {256, 128, CU_AD_FORMAT_FLOAT, 4};
  CUarray a = nullptr, b = nullptr, c = nullptr;
  CHECK(create(&a, &d2) == CUDA_SUCCESS && a != nullptr);
  CHECK(stats().charged_bytes == 512 * Ki);
  /* 64 x 64 x 80 half: 640 KiB, past the cap with the first. */
  CUDA_ARRAY3D_DESCRIPTOR big = {64, 64, 80, CU_AD_FORMAT_HALF, 1, 0};
  uint64_t before = calls("cuArray3DCreate_v2");
  CHECK(create3d(&b, &big) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(calls("cuArray3DCreate_v2") == before && stats().refused == 1);
  /* 1-D uchar2, 1000 wide, 16 layers: 32000 bytes. */
  CUDA_ARRAY3D_DESCRIPTOR layered = {1000, 0, 16, CU_AD_FORMAT_UNSIGNED_INT8,
                                     2, kArray3DLayered};
  CHECK(create3d(&b, &layered) == CUDA_SUCCESS);
  /* A 32 x 32 x 32 uint16 3-D array: 64 KiB. */
  CUDA_ARRAY3D_DESCRIPTOR cube = {32, 32, 32, CU_AD_FORMAT_UNSIGNED_INT16, 1,
                                  0};
  CHECK(create3d(&c, &cube) == CUDA_SUCCESS);
  /* 64 x 64 float, 4 mip levels: 4 x (4096 + 1024 + 256 + 64) bytes. */
  CUDA_ARRAY3D_DESCRIPTOR mip = {64, 64, 0, CU_AD_FORMAT_FLOAT, 1, 0};
  CUmipmappedArray m = nullptr;
  CHECK(mipmapped(&m, &mip, 4) == CUDA_SUCCESS);
  uint64_t want = 512 * Ki + 32000 + 64 * Ki + 4 * 5440;
  CHECK(stats().charged_bytes == want);
  size_t freeb = 0, total = 0;
  mem_info(&freeb, &total);
  CHECK(total == 1 * Mi && freeb == 1 * Mi - want);
  CHECK(destroy(a) == CUDA_SUCCESS && destroy(b) == CUDA_SUCCESS &&
        destroy(c) == CUDA_SUCCESS && destroy_mipmapped(m) == CUDA_SUCCESS);
  CHECK(stats().charged_bytes == 0);

  auto* add = (fn_cuGraphAddMemAllocNode*)proc("cuGraphAddMemAllocNode",
                                               11040);
  auto* destroy_graph = (fn_cuGraphDestroy*)proc("cuGraphDestroy", 10000);
  CUDA_MEM_ALLOC_NODE_PARAMS np;
  memset(&np, 0, sizeof(np));
  np.poolProps.allocType = CU_MEM_ALLOCATION_TYPE_PINNED;
  np.poolProps.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  np.poolProps.location.id = 0;
  np.bytesize = 768 * Ki;
  CUgraph graph = (CUgraph)(uintptr_t)0x6000;
  CUgraphNode n1 = nullptr, n2 = nullptr;
  CHECK(add(&n1, graph, nullptr, 0, &np) == CUDA_SUCCESS && n1 != nullptr);
  CHECK(stats().charged_bytes == 768 * Ki);
  np.bytesize = 512 * Ki;
  before = calls("cuGraphAddMemAllocNode");
  CHECK(add(&n2, graph, &n1, 1, &np) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(calls("cuGraphAddMemAllocNode") == before);
  CHECK(destroy_graph(graph) == CUDA_SUCCESS);
  CHECK(stats().charged_bytes == 0);
  mem_info(&freeb, &total);
  CHECK(freeb == 1 * Mi);
  printf("array: arrays, layered and mipmapped arrays and graph memory "
         "nodes charged from their descriptors, refused past the cap, "
         "released to 0\n");
  return 0;
}

/* A memory node's charge outlives its graph while an executable graph
 * made from it lives, and passes to its address while an allocation a
 * launch made is live: add, instantiate, destroy the graph and launch
 * cannot allocate past the cap. */
static int sc_graph_node() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  open_driver();
  auto* add = (fn_cuGraphAddMemAllocNode*)proc("cuGraphAddMemAllocNode",
                                               11040);
  auto* add_free = (fn_cuGraphAddMemFreeNode*)proc("cuGraphAddMemFreeNode",
                                                   11040);
  auto* add_node = (fn_cuGraphAddNode*)proc("cuGraphAddNode", 12020);
  auto* add_node_v2 = (fn_cuGraphAddNode_v2*)proc("cuGraphAddNode", 12030);
  auto* instantiate =
      (fn_cuGraphInstantiateWithFlags*)proc("cuGraphInstantiate", 12000);
  auto* instantiate_v2 =
      (fn_cuGraphInstantiate_v2*)proc("cuGraphInstantiate", 11000);
  auto* destroy_exec = (fn_cuGraphExecDestroy*)proc("cuGraphExecDestroy");
  auto* destroy = (fn_cuGraphDestroy*)proc("cuGraphDestroy");
  auto* run = (fn_cuGraphLaunch*)proc("cuGraphLaunch");
  auto charged = [] { return stats().charged_bytes; };
  CUDA_MEM_ALLOC_NODE_PARAMS np;
  memset(&np, 0, sizeof(np));
  np.poolProps.allocType = CU_MEM_ALLOCATION_TYPE_PINNED;
  np.poolProps.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  np.bytesize = 768 * Ki;
  CUDA_MEM_ALLOC_NODE_PARAMS other = np;
  auto graph = [](uintptr_t id) { return (CUgraph)(0x60000 + id); };
  CUgraphNode n = nullptr, m = nullptr;
  CUgraphExec e = nullptr;

  /* Add, instantiate, destroy the graph: the executable graph holds the
   * charge, and a second node past the cap is refused. */
  CHECK(add(&n, graph(1), nullptr, 0, &np) == CUDA_SUCCESS);
  CHECK(instantiate(&e, graph(1), 0) == CUDA_SUCCESS);
  CHECK(destroy(graph(1)) == CUDA_SUCCESS);
  CHECK(charged() == 768 * Ki);
  CHECK(add(&m, graph(2), nullptr, 0, &other) == CUDA_ERROR_OUT_OF_MEMORY);
  /* Its launch leaves the allocation live: destroying the executable graph
   * passes the charge to the address, and the address's free releases it. */
  CHECK(run(e, nullptr) == CUDA_SUCCESS);
  CHECK(destroy_exec(e) == CUDA_SUCCESS);
  CHECK(charged() == 768 * Ki);
  CHECK(add(&m, graph(2), nullptr, 0, &other) == CUDA_ERROR_OUT_OF_MEMORY);
  release(np.dptr);
  CHECK(charged() == 0);

  /* Through cuGraphAddNode: a graph that frees its own allocation leaves
   * nothing live once it and its executable graph are gone. */
  CUgraphNodeParams gp;
  memset(&gp, 0, sizeof(gp));
  gp.type = CU_GRAPH_NODE_TYPE_MEM_ALLOC;
  gp.alloc = np;
  gp.alloc.bytesize = 512 * Ki;
  CHECK(add_node(&n, graph(3), nullptr, 0, &gp) == CUDA_SUCCESS);
  CHECK(charged() == 512 * Ki);
  CUgraphNodeParams fp;
  memset(&fp, 0, sizeof(fp));
  fp.type = CU_GRAPH_NODE_TYPE_MEM_FREE;
  fp.free.dptr = gp.alloc.dptr;
  CHECK(add_node_v2(&m, graph(3), &n, nullptr, 1, &fp) == CUDA_SUCCESS);
  CHECK(instantiate_v2(&e, graph(3), nullptr, nullptr, 0) == CUDA_SUCCESS);
  CHECK(run(e, nullptr) == CUDA_SUCCESS);
  CHECK(destroy_exec(e) == CUDA_SUCCESS);
  CHECK(charged() == 512 * Ki);
  CUgraphNodeParams big = gp;
  big.alloc.bytesize = 768 * Ki;
  CHECK(add_node_v2(&m, graph(4), nullptr, nullptr, 0, &big) ==
        CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(destroy(graph(3)) == CUDA_SUCCESS);
  CHECK(charged() == 0);

  /* An allocation freed by another graph's free node: its charge passes to
   * the address when its own graph goes, and that launch releases it. */
  CUgraphExec e6 = nullptr;
  CHECK(add(&n, graph(5), nullptr, 0, &np) == CUDA_SUCCESS);
  CHECK(add_free(&m, graph(6), nullptr, 0, np.dptr) == CUDA_SUCCESS);
  CHECK(instantiate(&e, graph(5), 0) == CUDA_SUCCESS);
  CHECK(instantiate(&e6, graph(6), 0) == CUDA_SUCCESS);
  CHECK(run(e, nullptr) == CUDA_SUCCESS);
  CHECK(destroy_exec(e) == CUDA_SUCCESS && destroy(graph(5)) == CUDA_SUCCESS);
  CHECK(charged() == 768 * Ki);
  CHECK(run(e6, nullptr) == CUDA_SUCCESS);
  CHECK(charged() == 0);
  CHECK(destroy_exec(e6) == CUDA_SUCCESS && destroy(graph(6)) == CUDA_SUCCESS);

  /* Freed outside any graph before both are destroyed: nothing lingers. */
  CHECK(add(&n, graph(7), nullptr, 0, &np) == CUDA_SUCCESS);
  CHECK(instantiate(&e, graph(7), 0) == CUDA_SUCCESS);
  CHECK(run(e, nullptr) == CUDA_SUCCESS);
  release(np.dptr);
  CHECK(charged() == 768 * Ki);
  CHECK(destroy(graph(7)) == CUDA_SUCCESS && destroy_exec(e) == CUDA_SUCCESS);
  CHECK(charged() == 0);
  size_t freeb = 0, total = 0;
  mem_info(&freeb, &total);
  CHECK(freeb == 1 * Mi);
  printf("graph_node: memory nodes stay charged through their executable "
         "graphs and live allocations, released to 0\n");
  return 0;
}

static int sc_vmm() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  open_driver();
  auto* create = (fn_cuMemCreate*)proc("cuMemCreate");
  auto* rel = (fn_cuMemRelease*)proc("cuMemRelease");
  CUmemAllocationProp dev_prop;
  memset(&dev_prop, 0, sizeof(dev_prop));
  dev_prop.type = CU_MEM_ALLOCATION_TYPE_PINNED;
  dev_prop.location.type = CU_MEM_LOCATION_TYPE_DEVICE;
  dev_prop.location.id = 0;
  CUmemAllocationProp host_prop = dev_prop;
  host_prop.location.type = (CUmemLocationType)2; /* HOST: uncharged */
  CUmemGenericAllocationHandle a = 0, b = 0, h = 0;
  CHECK(create(&a, 512 * Ki, &dev_prop, 0) == CUDA_SUCCESS);
  CHECK(create(&b, 768 * Ki, &dev_prop, 0) == CUDA_ERROR_OUT_OF_MEMORY);
  CHECK(create(&h, 2 * Mi, &host_prop, 0) == CUDA_SUCCESS);
  CHECK(stats().charged_bytes == 512 * Ki);
  CHECK(rel(a) == CUDA_SUCCESS);
  CHECK(create(&b, 768 * Ki, &dev_prop, 0) == CUDA_SUCCESS);
  CHECK(rel(b) == CUDA_SUCCESS && rel(h) == CUDA_SUCCESS);
  CHECK(stats().charged_bytes == 0);
  printf("vmm: cuMemCreate charged per device handle, released by "
         "cuMemRelease\n");
  return 0;
}

/* A 20% FORCE share with a 100 ms floor per launch: the 400 ms burst pays
 * four launches, the fifth waits for the bucket. */
static void floor_env() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "20", 1);
  setenv("VTPU_CORE_UTILIZATION_POLICY", "FORCE", 1);
  setenv("VTPU_MIN_EXEC_COST_US", "100000", 1);
}

static int sc_launch_ex() {
  floor_env();
  open_driver();
  auto* ex = (fn_cuLaunchKernelEx*)proc("cuLaunchKernelEx");
  auto* ex_ptsz = (fn_cuLaunchKernelEx*)proc(
      "cuLaunchKernelEx", 12080, CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM);
  CUlaunchConfig cfg;
  memset(&cfg, 0, sizeof(cfg));
  cfg.gridDimX = cfg.gridDimY = cfg.gridDimZ = 1;
  cfg.blockDimX = 128;
  cfg.blockDimY = cfg.blockDimZ = 1;
  double t0 = mono_s();
  for (int i = 0; i < 5; i++)
    CHECK((i % 2 ? ex_ptsz : ex)(&cfg, nullptr, nullptr, nullptr) ==
          CUDA_SUCCESS);
  double elapsed = mono_s() - t0;
  Stats s = stats();
  auto* calls = mock<uint64_t(const char*)>("mockCalls");
  printf("launch_ex: 5 launches in %.3f s, %llu waited\n", elapsed,
         (unsigned long long)s.gate_waits);
  CHECK(s.launches == 5 && s.gate_waits >= 1 && elapsed > 0.08);
  CHECK(calls("cuLaunchKernelEx") == 3 && calls("cuLaunchKernelEx_ptsz") == 2);
  return 0;
}

static int sc_graph() {
  floor_env();
  open_driver();
  auto* graph = (fn_cuGraphLaunch*)proc("cuGraphLaunch");
  double t0 = mono_s();
  for (int i = 0; i < 5; i++)
    CHECK(graph(nullptr, nullptr) == CUDA_SUCCESS);
  double elapsed = mono_s() - t0;
  Stats s = stats();
  printf("graph: 5 graph launches in %.3f s, %llu waited\n", elapsed,
         (unsigned long long)s.gate_waits);
  CHECK(s.graph_launches == 5 && s.gate_waits >= 1 && elapsed > 0.08);
  return 0;
}

static int sc_failclosed() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Mi", 1);
  setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE",
         "/nonexistent-vtpu-dir/region.cache", 1);
  open_driver();
  auto* calls = mock<uint64_t(const char*)>("mockCalls");
  alloc(4 * Ki, CUDA_ERROR_NOT_PERMITTED);
  CHECK(calls("cuMemAlloc_v2") == 0);
  CHECK(launch() == CUDA_ERROR_NOT_PERMITTED);
  CHECK(calls("cuLaunchKernel") == 0);
  CHECK(stats().state == 2);
  printf("failclosed: a quota with no region refuses every allocation and "
         "launch\n");
  return 0;
}

static int sc_forward_other() {
  typedef pid_t getpid_fn(void);
  void* libc_getpid = dlvsym(RTLD_DEFAULT, "getpid", "GLIBC_2.2.5");
  CHECK(libc_getpid != nullptr);
  CHECK(dlsym(RTLD_DEFAULT, "getpid") == libc_getpid);
  CHECK(dlsym(RTLD_NEXT, "getpid") == libc_getpid);
  void* libc = dlopen("libc.so.6", RTLD_LAZY | RTLD_NOLOAD);
  CHECK(libc != nullptr && dlsym(libc, "getpid") == libc_getpid);
  CHECK(((getpid_fn*)dlsym(RTLD_NEXT, "getpid"))() == getpid());
  CHECK(dlsym(RTLD_DEFAULT, "vtpu_no_such_symbol") == nullptr);
  /* The next dlsym after this program's is the interposer's own. */
  Dl_info info;
  CHECK(dladdr(dlsym(RTLD_NEXT, "dlsym"), &info) && info.dli_fname &&
        strstr(info.dli_fname, "vtpu_cuda") != nullptr);
  printf("forward_other: non-CUDA names resolve as without the "
         "interposer\n");
  return 0;
}

/* ---- per-card busy files ------------------------------------------- */

/* Mirror of the interposer's BusySlot; a busy file holds kBusySlots. */
struct BusySlot {
  uint64_t owner, beat_ns;
  int32_t pid, pad;
  uint64_t until_ns[16];
};
static const int kBusySlots = 64;
static const char kCard[] = "GPU-test-card";

static uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

/* A card's busy file at full size, as the daemon stages it. */
static BusySlot* map_card_file(const std::string& dir) {
  std::string path = dir + "/" + kCard + ".busy";
  int fd = open(path.c_str(), O_RDWR | O_CREAT, 0666);
  CHECK(fd >= 0);
  size_t size = sizeof(BusySlot) * kBusySlots;
  CHECK(ftruncate(fd, (off_t)size) == 0);
  void* p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  close(fd);
  CHECK(p != MAP_FAILED);
  return (BusySlot*)p;
}

/* A busy directory beside the region, in the env as Allocate sets it;
 * with `stage`, the card's file in it as the daemon makes it. */
static std::string busy_dir_env(bool stage = true) {
  std::string dir =
      std::string(getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE")) + ".busy.d";
  CHECK(mkdir(dir.c_str(), 0777) == 0 || errno == EEXIST);
  setenv("VTPU_DEVICE_BUSY_DIR", dir.c_str(), 1);
  setenv("VTPU_DEVICE_MAP", (std::string("0:") + kCard).c_str(), 1);
  if (stage) map_card_file(dir);
  return dir;
}

static void remove_busy_dir(const std::string& dir) {
  unlink((dir + "/" + kCard + ".busy").c_str());
  unlink((getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE") + std::string(".busy"))
             .c_str());
  rmdir(dir.c_str());
}

/* The slot this process holds, or -1. */
static int my_slot(BusySlot* slots) {
  for (int i = 0; i < kBusySlots; i++)
    if (__atomic_load_n(&slots[i].pid, __ATOMIC_RELAXED) == getpid() &&
        __atomic_load_n(&slots[i].owner, __ATOMIC_ACQUIRE) != 0)
      return i;
  return -1;
}

static int sc_busy_dir_pair() {
  /* Two processes with DIFFERENT regions (as two pods of one card get
   * from Allocate) and one busy directory, each keeping its mock device
   * busy all the time: each must book about half of the wall time, as
   * the card would give each half.  The region's own busy file could not
   * show them to each other. */
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  std::string dir = busy_dir_env();
  std::string region = getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE");
  int fds[2];
  CHECK(pipe(fds) == 0);
  pid_t child = fork();
  CHECK(child >= 0);
  std::string mine = region + (child == 0 ? ".b" : ".a");
  setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", mine.c_str(), 1);
  open_driver();
  busy_loop(0.6);
  Stats s0 = stats();
  double t0 = mono_s();
  busy_loop(3.0);
  Stats s1 = stats();
  double share = (s1.booked_us - s0.booked_us) / ((mono_s() - t0) * 1e6);
  unlink(mine.c_str());
  if (child == 0) {
    double got[2] = {share, (double)s1.shared_ticks};
    CHECK(write(fds[1], got, sizeof(got)) == (ssize_t)sizeof(got));
    _exit(0);
  }
  double other[2] = {0, 0};
  CHECK(read(fds[0], other, sizeof(other)) == (ssize_t)sizeof(other));
  int st = 0;
  CHECK(waitpid(child, &st, 0) == child && WIFEXITED(st) &&
        WEXITSTATUS(st) == 0);
  remove_busy_dir(dir);
  printf("busy_dir_pair: booked %.3f and %.3f of the wall time, shared "
         "ticks %llu and %.0f\n", share, other[0],
         (unsigned long long)s1.shared_ticks, other[1]);
  CHECK(s1.shared_ticks > 0 && other[1] > 0);
  CHECK(share > 0.35 && share < 0.65 && other[0] > 0.35 && other[0] < 0.65);
  return 0;
}

/* A co-tenant in another container: its slot's heartbeat kept fresh,
 * busy all the time, under a pid no kill() reaches from here. */
struct Neighbour {
  BusySlot* slot;
  std::atomic<bool> stop{false};
};

static void* neighbour_main(void* arg) {
  Neighbour* n = (Neighbour*)arg;
  while (!n->stop.load()) {
    uint64_t now = mono_ns();
    __atomic_store_n(&n->slot->until_ns[0], now + 100000000ull,
                     __ATOMIC_RELAXED);
    __atomic_store_n(&n->slot->beat_ns, now, __ATOMIC_RELEASE);
    usleep(20000);
  }
  return nullptr;
}

static pid_t unreachable_pid() {
  for (pid_t p = 4194000; p > 1000; p -= 7)
    if (kill(p, 0) != 0 && errno == ESRCH) return p;
  CHECK(!"no free pid");
  return 0;
}

static int sc_slot_fresh_unreachable() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  std::string dir = busy_dir_env();
  BusySlot* slots = map_card_file(dir);
  Neighbour n;
  n.slot = &slots[0];
  slots[0].owner = 0x5eed5eed5eed5eedull;
  slots[0].pid = unreachable_pid();
  slots[0].beat_ns = mono_ns();
  pthread_t t;
  CHECK(pthread_create(&t, nullptr, neighbour_main, &n) == 0);
  open_driver();
  busy_loop(1.0);  /* five lease periods */
  int mine = my_slot(slots);
  Stats s = stats();
  n.stop = true;
  pthread_join(t, nullptr);
  printf("slot_fresh_unreachable: the neighbour (pid %d, unreachable) "
         "keeps slot 0, this process holds slot %d; shared ticks %llu\n",
         slots[0].pid, mine, (unsigned long long)s.shared_ticks);
  CHECK(slots[0].owner == 0x5eed5eed5eed5eedull);
  CHECK(mine > 0);
  CHECK(s.shared_ticks > 0 && s.shared_ticks == s.busy_ticks);
  remove_busy_dir(dir);
  return 0;
}

static int sc_slot_lapsed() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  std::string dir = busy_dir_env();
  BusySlot* slots = map_card_file(dir);
  /* A holder that stopped beating 5 s ago, its last busy mark long past. */
  slots[0].owner = 0x5eed5eed5eed5eedull;
  slots[0].pid = getpid() + 1;
  slots[0].beat_ns = mono_ns() - 5000000000ull;
  slots[0].until_ns[0] = slots[0].beat_ns;
  open_driver();
  busy_loop(0.3);
  int mine = my_slot(slots);
  Stats s = stats();
  printf("slot_lapsed: this process took slot %d; shared ticks %llu\n", mine,
         (unsigned long long)s.shared_ticks);
  CHECK(mine == 0 && slots[0].owner != 0x5eed5eed5eed5eedull);
  CHECK(s.busy_ticks > 0 && s.shared_ticks == 0);
  remove_busy_dir(dir);
  return 0;
}

/* What a co-tenant could plant where a card's busy file goes: the watcher
 * must leave it alone and meet only its region's processes. */
static int busy_refused(const char* what, bool symlink_it) {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "4Mi", 1);
  setenv("MOCK_KERNEL_US", "10000", 1);
  std::string dir = busy_dir_env(false);
  std::string card = dir + "/" + kCard + ".busy";
  std::string victim =
      std::string(getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE")) + ".victim";
  const char kText[] = "the victim's bytes\n";
  int fd = open(victim.c_str(), O_RDWR | O_CREAT | O_TRUNC, 0600);
  CHECK(fd >= 0 && write(fd, kText, sizeof(kText) - 1) ==
                       (ssize_t)(sizeof(kText) - 1));
  close(fd);
  if (symlink_it)
    CHECK(symlink(victim.c_str(), card.c_str()) == 0);
  else
    CHECK(link(victim.c_str(), card.c_str()) == 0);
  open_driver();
  busy_loop(0.3);
  Stats s = stats();
  char got[64] = {};
  fd = open(victim.c_str(), O_RDONLY);
  CHECK(fd >= 0);
  ssize_t n = read(fd, got, sizeof(got));
  close(fd);
  struct stat st;
  CHECK(stat(victim.c_str(), &st) == 0);
  printf("%s: the planted file keeps %zd bytes, mode %o; busy ticks %llu, "
         "shared %llu\n", what, n, st.st_mode & 07777,
         (unsigned long long)s.busy_ticks, (unsigned long long)s.shared_ticks);
  CHECK(n == (ssize_t)(sizeof(kText) - 1) && memcmp(got, kText, n) == 0);
  CHECK((st.st_mode & 07777) == 0600 && st.st_size == n);
  CHECK(s.meter == 1 && s.busy_ticks > 0 && s.shared_ticks == 0);
  unlink(victim.c_str());
  remove_busy_dir(dir);
  return 0;
}

static int sc_busy_symlink() {
  return busy_refused("busy_symlink", true);
}

/* A regular file, but short: neither resized nor mapped. */
static int sc_busy_short() { return busy_refused("busy_short", false); }

static int sc_busy_file_bytes() {
  /* The busy file's size: this program's mirror of the slot layout, and
   * the library's own (printed for tests/test_torch_interposer.py to
   * hold plugin/grant.py's BUSY_FILE_BYTES to). */
  auto* f = (size_t (*)())dlsym(RTLD_DEFAULT, "vtpu_cuda_busy_file_bytes");
  CHECK(f != nullptr);
  size_t mirror = sizeof(BusySlot) * kBusySlots;
  printf("busy_file_bytes: library %zu mirror %zu\n", f(), mirror);
  CHECK(f() == mirror);
  return 0;
}

static int sc_grant_env() {
  /* Started under an Allocate grant's env (tests/test_torch_interposer.py
   * passes it, with the cap it expects in VTPU_TEST_EXPECT_TOTAL): the
   * quota view is the grant's cap, and the first launch puts this process
   * in its card's busy file. */
  const char* want = getenv("VTPU_TEST_EXPECT_TOTAL");
  const char* dir = getenv("VTPU_DEVICE_BUSY_DIR");
  const char* map = getenv("VTPU_DEVICE_MAP");
  CHECK(want && dir && map && strncmp(map, "0:", 2) == 0);
  open_driver();
  size_t freeb = 0, total = 0;
  mem_info(&freeb, &total);
  CHECK(total == strtoull(want, nullptr, 10) && freeb == total);
  CHECK(stats().state == 1);
  CHECK(launch() == CUDA_SUCCESS);
  /* The daemon staged the file; this process must hold a slot in it. */
  std::string path = std::string(dir) + "/" + (map + 2) + ".busy";
  int fd = open(path.c_str(), O_RDONLY);
  CHECK(fd >= 0);
  void* p = mmap(nullptr, sizeof(BusySlot) * kBusySlots, PROT_READ,
                 MAP_SHARED, fd, 0);
  close(fd);
  CHECK(p != MAP_FAILED);
  double t0 = mono_s();
  int slot = -1;
  while ((slot = my_slot((BusySlot*)p)) < 0 && mono_s() - t0 < 2)
    usleep(10000);
  CHECK(slot >= 0);
  printf("grant_env: cuMemGetInfo reports the grant's %zu-byte cap; slot %d "
         "of busy file %s\n", total, slot, path.c_str());
  return 0;
}

/* ---- the utilisation view ------------------------------------------- */

/* nvmlDeviceGetUtilizationRates, as nvidia-smi reaches it, and device 0. */
static fn_nvmlDeviceGetUtilizationRates* nvml_util(nvmlDevice_t* dev) {
  void* nvml = dlopen("libnvidia-ml.so.1", RTLD_NOW | RTLD_LOCAL);
  CHECK(nvml != nullptr);
  auto* init = (fn_nvmlInit_v2*)dlsym(nvml, "nvmlInit_v2");
  auto* by_index = (fn_nvmlDeviceGetHandleByIndex_v2*)dlsym(
      nvml, "nvmlDeviceGetHandleByIndex_v2");
  auto* util = (fn_nvmlDeviceGetUtilizationRates*)dlsym(
      nvml, "nvmlDeviceGetUtilizationRates");
  CHECK(init && by_index && util);
  CHECK(init() == NVML_SUCCESS && by_index(0, dev) == NVML_SUCCESS);
  return util;
}

/* One call; its wall time in `*secs`. */
static nvmlUtilization_t util_call(fn_nvmlDeviceGetUtilizationRates* f,
                                   nvmlDevice_t dev, double* secs) {
  nvmlUtilization_t u = {12345, 12345};
  double t0 = mono_s();
  CHECK(f(dev, &u) == NVML_SUCCESS);
  *secs = mono_s() - t0;
  return u;
}

/* The region as a node's monitor opens it: adopted as it is, no slot. */
static vtpu_region* monitor_region() {
  vtpu_region* r = vtpu_region_open(
      getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE"), 0, nullptr, nullptr);
  CHECK(r != nullptr);
  return r;
}

static int n_procs(vtpu_region* r) {
  vtpu_device_stats st;
  CHECK(vtpu_device_get_stats(r, 0, &st) == 0);
  return st.n_procs;
}

/* The pod's view with the quota env set: the first call samples the
 * region over 1/6 s (nothing ran: 0); a call right after repeats it at
 * once; then `busy_us` of device time booked over `gap` seconds reads as
 * busy_us / gap of the card, rescaled by `core` (0: none), clamped to 100.
 * The window is at least `gap`, so the reading is at most `want` and
 * loses at most a quarter of it to scheduling.  `memory` is always 0, and
 * no call takes a slot in the region. */
static void util_reads(int core, uint64_t busy_us, double gap,
                       unsigned int want) {
  nvmlDevice_t dev = nullptr;
  auto* util = nvml_util(&dev);
  double secs = 0;
  nvmlUtilization_t u = util_call(util, dev, &secs);
  double sampled_at = mono_s();
  CHECK(u.gpu == 0 && u.memory == 0 && secs >= 0.16);
  vtpu_region* r = monitor_region();
  int procs = n_procs(r);
  u = util_call(util, dev, &secs);
  CHECK(u.gpu == 0 && u.memory == 0 && secs < 0.1);
  vtpu_busy_add(r, 0, busy_us);
  double wait = sampled_at + gap - mono_s();
  if (wait > 0) usleep((useconds_t)(wait * 1e6));
  u = util_call(util, dev, &secs);
  printf("nvml_util: core %d%%, %llu us over %.3f s: gpu %u (want %u), "
         "memory %u\n", core, (unsigned long long)busy_us, gap, u.gpu, want,
         u.memory);
  CHECK(u.gpu <= want && u.gpu * 4 >= want * 3 && u.memory == 0);
  CHECK(secs < 0.1);
  /* Twice the window's length booked in it: clamped. */
  vtpu_busy_add(r, 0, (uint64_t)(2 * gap * 1e6));
  usleep((useconds_t)(gap * 1e6));
  u = util_call(util, dev, &secs);
  CHECK(u.gpu == 100 && u.memory == 0);
  CHECK(n_procs(r) == procs && procs == 0);
  vtpu_region_close(r);
}

/* Run this program's `scenario` in a child process; true when it held. */
static bool run_scenario(const char* scenario) {
  pid_t pid = fork();
  if (pid == 0) {
    execl("/proc/self/exe", "/proc/self/exe", scenario, (char*)nullptr);
    _exit(127);
  }
  int st = 0;
  waitpid(pid, &st, 0);
  return WIFEXITED(st) && WEXITSTATUS(st) == 0;
}

/* At a 50% share; then with no share, and with no quota env at all. */
static int sc_nvml_util() {
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Gi", 1);
  setenv("VTPU_DEVICE_CORE_LIMIT", "50", 1);
  util_reads(50, 60000, 0.3, 40);   /* 20% of the card: 40% of the share */
  CHECK(run_scenario("nvml_util_noshare"));
  CHECK(run_scenario("nvml_util_forward"));
  printf("nvml_util: the pod's own time, of its share\n");
  return 0;
}

static int sc_nvml_util_noshare() {
  std::string region = std::string(getenv(
      "VTPU_DEVICE_MEMORY_SHARED_CACHE")) + ".noshare";
  unlink(region.c_str());
  setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", region.c_str(), 1);
  setenv("VTPU_DEVICE_HBM_LIMIT_0", "1Gi", 1);
  unsetenv("VTPU_DEVICE_CORE_LIMIT");
  util_reads(0, 60000, 0.3, 20);    /* 20% of the card, no share */
  unlink(region.c_str());
  return 0;
}

/* No quota env: NVML's own answer, unchanged and unsampled. */
static int sc_nvml_util_forward() {
  unsetenv("VTPU_DEVICE_HBM_LIMIT_0");
  unsetenv("VTPU_DEVICE_CORE_LIMIT");
  nvmlDevice_t dev = nullptr;
  auto* util = nvml_util(&dev);
  double secs = 0;
  nvmlUtilization_t u = util_call(util, dev, &secs);
  CHECK(u.gpu == 77 && u.memory == 55 && secs < 0.1);
  return 0;
}

struct Scenario {
  const char* name;
  int (*fn)();
  bool expect_sigkill;
};

static const Scenario kScenarios[] = {
    {"mem", sc_mem, false},
    {"throttle", sc_throttle, false},
    {"ptsz_meter", sc_ptsz_meter, false},
    {"ptsz_threads", sc_ptsz_threads, false},
    {"shared_region", sc_shared_region, false},
    {"sole_fast", sc_sole_fast, false},
    {"floor_zero_latency", sc_floor_zero_latency, false},
    {"spill", sc_spill, false},
    {"killer", sc_killer, true},
    {"procaddr", sc_procaddr, false},
    {"meminfo_nvml", sc_meminfo_nvml, false},
    {"array", sc_array, false},
    {"graph_node", sc_graph_node, false},
    {"vmm", sc_vmm, false},
    {"launch_ex", sc_launch_ex, false},
    {"graph", sc_graph, false},
    {"failclosed", sc_failclosed, false},
    {"forward_other", sc_forward_other, false},
    {"busy_dir_pair", sc_busy_dir_pair, false},
    {"slot_fresh_unreachable", sc_slot_fresh_unreachable, false},
    {"slot_lapsed", sc_slot_lapsed, false},
    {"busy_symlink", sc_busy_symlink, false},
    {"busy_short", sc_busy_short, false},
    {"busy_file_bytes", sc_busy_file_bytes, false},
    {"grant_env", sc_grant_env, false},
    {"nvml_util", sc_nvml_util, false},
    {"nvml_util_noshare", sc_nvml_util_noshare, false},
    {"nvml_util_forward", sc_nvml_util_forward, false},
};

int main(int argc, char** argv) {
  if (dlsym(RTLD_DEFAULT, "vtpu_cuda_interposer_ident") == nullptr) {
    fprintf(stderr, "libvtpu_cuda.so is not preloaded\n");
    return 2;
  }
  std::string region = "/tmp/vtpu_cuda_test_" + std::to_string(getpid()) +
                       ".cache";
  if (!getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE"))
    setenv("VTPU_DEVICE_MEMORY_SHARED_CACHE", region.c_str(), 1);
  if (argc > 1) {
    for (const Scenario& s : kScenarios) {
      if (strcmp(s.name, argv[1]) != 0) continue;
      int rc = s.fn();
      unlink(region.c_str());
      if (rc == 0) printf("scenario %s: OK\n", s.name);
      return rc;
    }
    fprintf(stderr, "unknown scenario %s\n", argv[1]);
    return 2;
  }
  int failures = 0;
  for (const Scenario& s : kScenarios) {
    pid_t pid = fork();
    if (pid == 0) {
      unsetenv("VTPU_DEVICE_MEMORY_SHARED_CACHE");
      execl("/proc/self/exe", argv[0], s.name, (char*)nullptr);
      _exit(127);
    }
    int st = 0;
    waitpid(pid, &st, 0);
    bool ok = s.expect_sigkill ? WIFSIGNALED(st) && WTERMSIG(st) == SIGKILL
                               : WIFEXITED(st) && WEXITSTATUS(st) == 0;
    if (!ok) {
      fprintf(stderr, "scenario %s FAILED (status %d)\n", s.name, st);
      failures++;
    }
  }
  unlink(region.c_str());
  if (failures == 0) printf("interposer_test: ALL OK\n");
  return failures == 0 ? 0 : 1;
}
