/* libvtpu_cuda.so — holds an unmodified CUDA process to its vGPU quota.
 *
 * The port's counterpart of vtpu's PJRT interposer
 * (native/vtpu_pjrt/interposer.cc) and of the reference's LD_PRELOAD
 * interceptor (SURVEY §2.9).  A tenant is started with
 *
 *     LD_PRELOAD=<this library> + the Allocate env (VTPU_DEVICE_HBM_LIMIT...)
 *
 * and needs no call of its own (shim/interposer.py builds the env).  The
 * library is first in the global symbol order, so it sees every way a
 * program reaches the driver:
 *
 *   dlsym                   exported here.  The CUDA runtime (shared, or
 *                           linked statically into a kernel library) gets
 *                           libcuda's cuGetProcAddress through dlsym on
 *                           libcuda's handle; NVML users get theirs the
 *                           same way.  Hooked names come back as wrappers,
 *                           every other name is forwarded untouched.
 *   cuGetProcAddress[_v2]   the runtime fetches every driver entry point
 *                           through it, by base name and CUDA version
 *                           ("cuMemAlloc" at 3020 is cuMemAlloc_v2), with
 *                           _ptsz variants for per-thread default streams.
 *                           The real lookup runs first; a wrapper replaces
 *                           its answer only when the pointer IS the real
 *                           address of a hooked function — pointers are
 *                           compared, never names, so versions and
 *                           variants resolve exactly as the driver says
 *                           and unhooked entry points (cuTensorMapEncode-
 *                           Tiled, which the sm90 kernel fetches through
 *                           cudaGetDriverEntryPoint) come back as they
 *                           are.
 *   the hooked names        exported directly too, for programs linked
 *                           against libcuda / libnvidia-ml.
 *
 * Enforcement, over the shared accounting region (native/vtpucore,
 * compiled in unchanged) that vtpu's tools and the port's pyshim read:
 *
 *   memory   cuMemAlloc_v2, cuMemAllocPitch_v2, cuMemAllocManaged,
 *            cuMemAllocAsync, cuMemAllocFromPoolAsync, cuMemCreate, the
 *            CUDA arrays (cuArrayCreate_v2, cuArray3DCreate_v2,
 *            cuMipmappedArrayCreate, sized from their descriptors) and
 *            graph memory nodes (cuGraphAddMemAllocNode, cuGraphAddNode)
 *            are charged BEFORE the real allocator runs and refused with
 *            CUDA_ERROR_OUT_OF_MEMORY past the cap (VTPU_ACTIVE_OOM_KILLER:
 *            SIGKILL instead; VTPU_OVERSUBSCRIBE: a synchronous allocation
 *            past the cap is made managed instead, uncharged — vtpu's host
 *            spill).  cuMemFree_v2, cuMemFreeAsync, cuMemRelease,
 *            cuArrayDestroy and cuMipmappedArrayDestroy release; a memory
 *            node's charge lasts as long as its graph, the executable
 *            graphs made from it (cuGraphInstantiate*, cuGraphExecDestroy)
 *            and the allocations their launches left live.
 *            The device is the current context's (cuMemAlloc takes none).
 *            PyTorch's caching allocator calls cudaMalloc once per
 *            segment (cuMemCreate per chunk with expandable segments), so
 *            charges fall at segment granularity, not per tensor.
 *   view     cuMemGetInfo_v2 reports (cap - region used, cap) and
 *            cuDeviceTotalMem_v2 the cap; nvmlDeviceGetMemoryInfo[_v2]
 *            the same, which is what nvidia-smi in the container shows.
 *   compute  cuLaunchKernel, cuLaunchKernelEx (cuBLAS's GEMMs on Hopper),
 *            cuLaunchCooperativeKernel and cuGraphLaunch, with their _ptsz
 *            variants, pass a gate that blocks while the region's token
 *            bucket is in debt (VTPU_CORE_UTILIZATION_POLICY: DISABLE
 *            never gates, FORCE always, DEFAULT while another process
 *            shares the region; VTPU_TASK_PRIORITY 0 borrows).  The launch
 *            path never synchronises, and calls the region only while the
 *            bucket is in debt or a floor is set.  A watcher
 *            thread books the process's OWN device time into the bucket
 *            and the duty counter: the time its streams have work
 *            pending, divided among the card's processes busy at the
 *            same time (the card time-slices between them).  Wall time
 *            around a synchronise would also bill a co-tenant's slices.
 *            VTPU_MIN_EXEC_COST_US charges a floor per launch up front.
 *            Processes meet in one busy file per physical card
 *            (<VTPU_DEVICE_BUSY_DIR>/<card uuid>.busy, the UUIDs from
 *            VTPU_DEVICE_MAP; the daemon makes each, Allocate mounts
 *            the granted cards'), so co-tenants of a card in other
 *            regions and other containers are seen; without the
 *            directory, the processes of one region meet in
 *            <region>.busy.  A launch on a thread's per-thread default
 *            stream, which no other thread can query, is followed by an
 *            event that the watcher queries instead.
 *
 * A quota env with no usable region (unopenable path, incompatible
 * layout, a value that does not parse) fails CLOSED: every hooked
 * allocation and launch is refused, nothing runs unenforced.  With no
 * quota env at all the library forwards everything.
 *
 * Not carried over from vtpu's interposer (ROADMAP Queue 1): core-split
 * device filtering (Allocate sets NVIDIA_VISIBLE_DEVICES, so the container
 * runtime shows the pod its cards or MIG instances only), donation and
 * staged residency (PJRT concepts), and preload.cc's dlopen redirect
 * (Allocate mounts this library over /etc/ld.so.preload).  Region
 * ordinals are the CUDA device ordinals, and NVML device i is taken as
 * CUDA device i, as they are in a container that Allocate gave its cards
 * (VTPU_DEVICE_MAP names the physical card behind each ordinal).  A device
 * past the region's last ordinal is charged to ordinal 0, as the pyshim's
 * clamp_dev does.
 */
#include <ctype.h>
#include <dlfcn.h>
#include <errno.h>
#include <fcntl.h>
#include <link.h>
#include <pthread.h>
#include <signal.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <sys/mman.h>
#include <sys/random.h>
#include <sys/stat.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <new>
#include <mutex>
#include <string>
#include <unordered_map>
#include <vector>

#include "cuda_abi.h"
#include "vtpu_core.h"

using namespace vtpu_abi;

#define EXPORT extern "C" __attribute__((visibility("default")))

extern char** environ;

/* ------------------------------------------------------------------ */
/* logging                                                            */
/* ------------------------------------------------------------------ */

static int g_log_level = 1;

#define LOG(level, ...)                              \
  do {                                               \
    if (g_log_level >= (level)) {                    \
      fprintf(stderr, "[vtpu_cuda] " __VA_ARGS__);   \
      fputc('\n', stderr);                           \
    }                                                \
  } while (0)

static uint64_t mono_ns() {
  struct timespec ts;
  clock_gettime(CLOCK_MONOTONIC, &ts);
  return (uint64_t)ts.tv_sec * 1000000000ull + (uint64_t)ts.tv_nsec;
}

/* ------------------------------------------------------------------ */
/* the real entry points                                              */
/* ------------------------------------------------------------------ */

typedef void* dlsym_fn(void*, const char*);

/* The real dlsym: libc's since glibc 2.34, libdl's before. */
static dlsym_fn* real_dlsym() {
  static std::atomic<dlsym_fn*> fn{nullptr};
  dlsym_fn* f = fn.load(std::memory_order_acquire);
  if (f == nullptr) {
    f = (dlsym_fn*)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.34");
    if (f == nullptr) f = (dlsym_fn*)dlvsym(RTLD_NEXT, "dlsym", "GLIBC_2.2.5");
    fn.store(f, std::memory_order_release);
  }
  return f;
}

enum { LIB_CUDA = 0, LIB_NVML = 1 };
static const char* const kSoname[] = {"libcuda.so.1", "libnvidia-ml.so.1"};

/* Real addresses of the unhooked functions this library calls.  Filled,
 * like the hooks' (resolve_reals), from the already-loaded library
 * (RTLD_NOLOAD: nothing is loaded, and no constructor runs, from inside
 * a hook). */
struct Real {
  std::atomic<fn_cuCtxGetDevice*> cuCtxGetDevice{nullptr};
  std::atomic<fn_cuCtxGetCurrent*> cuCtxGetCurrent{nullptr};
  std::atomic<fn_cuCtxSetCurrent*> cuCtxSetCurrent{nullptr};
  std::atomic<fn_cuStreamQuery*> cuStreamQuery{nullptr};
  std::atomic<fn_cuMemAllocManaged*> cuMemAllocManaged{nullptr};
  std::atomic<fn_cuEventCreate*> cuEventCreate{nullptr};
  std::atomic<fn_cuEventRecord*> cuEventRecord{nullptr};
  std::atomic<fn_cuEventQuery*> cuEventQuery{nullptr};
  std::atomic<fn_cuEventDestroy_v2*> cuEventDestroy{nullptr};
};
static Real R;

/* One hooked symbol: its exported name, the wrapper that replaces it and
 * the real function it forwards to. */
struct Hook {
  const char* name;
  int lib;
  void* wrapper;
  std::atomic<void*> real;
};

static void* real_of(int lib, const char* name) {
  void* h = dlopen(kSoname[lib], RTLD_LAZY | RTLD_NOLOAD);
  if (h == nullptr) return nullptr;
  void* p = real_dlsym()(h, name);
  dlclose(h);
  return p;
}

/* Declared below with the wrappers. */
extern Hook g_hooks[];
extern const size_t g_nhooks;

/* Fill every hook's real address of `lib` (idempotent). */
static void resolve_reals(int lib) {
  static std::atomic<bool> done[2];
  if (done[lib].load(std::memory_order_acquire)) return;
  void* h = dlopen(kSoname[lib], RTLD_LAZY | RTLD_NOLOAD);
  if (h == nullptr) return;
  for (size_t i = 0; i < g_nhooks; i++) {
    Hook& k = g_hooks[i];
    if (k.lib == lib && k.real.load(std::memory_order_acquire) == nullptr)
      k.real.store(real_dlsym()(h, k.name), std::memory_order_release);
  }
  if (lib == LIB_CUDA) {
    R.cuCtxGetDevice.store(
        (fn_cuCtxGetDevice*)real_dlsym()(h, "cuCtxGetDevice"));
    R.cuCtxGetCurrent.store(
        (fn_cuCtxGetCurrent*)real_dlsym()(h, "cuCtxGetCurrent"));
    R.cuCtxSetCurrent.store(
        (fn_cuCtxSetCurrent*)real_dlsym()(h, "cuCtxSetCurrent"));
    R.cuStreamQuery.store((fn_cuStreamQuery*)real_dlsym()(h, "cuStreamQuery"));
    R.cuMemAllocManaged.store(
        (fn_cuMemAllocManaged*)real_dlsym()(h, "cuMemAllocManaged"));
    R.cuEventCreate.store((fn_cuEventCreate*)real_dlsym()(h, "cuEventCreate"));
    R.cuEventRecord.store((fn_cuEventRecord*)real_dlsym()(h, "cuEventRecord"));
    R.cuEventQuery.store((fn_cuEventQuery*)real_dlsym()(h, "cuEventQuery"));
    R.cuEventDestroy.store(
        (fn_cuEventDestroy_v2*)real_dlsym()(h, "cuEventDestroy_v2"));
  }
  dlclose(h);
  done[lib].store(true, std::memory_order_release);
}

static Hook* hook_named(const char* name) {
  for (size_t i = 0; i < g_nhooks; i++)
    if (strcmp(g_hooks[i].name, name) == 0) return &g_hooks[i];
  return nullptr;
}

/* The real function behind hook `k`, resolved on first use. */
template <class F>
static F* real(Hook& k) {
  void* p = k.real.load(std::memory_order_acquire);
  if (p == nullptr) {
    resolve_reals(k.lib);
    p = k.real.load(std::memory_order_acquire);
  }
  return (F*)p;
}

/* ------------------------------------------------------------------ */
/* quota env (mirrors utils/envspec.py quota_from_env)                */
/* ------------------------------------------------------------------ */

enum { POLICY_DEFAULT = 0, POLICY_FORCE = 1, POLICY_DISABLE = 2 };
enum { STATE_OFF = 0, STATE_ENFORCING = 1, STATE_FAILCLOSED = 2 };

struct Quota {
  bool any = false;  /* the env sets an HBM or a compute limit */
  bool bad = false;  /* a value envspec would reject */
  int ndev = 1;
  uint64_t limits[VTPU_MAX_DEVICES] = {};
  int32_t core_pct = 0;
  int policy = POLICY_DEFAULT;
  int priority = 1;
  bool oversubscribe = false;
  bool oom_killer = false;
  uint64_t min_cost_us = 0;
  std::string region;
  std::string busy_dir;                 /* VTPU_DEVICE_BUSY_DIR */
  std::string uuids[VTPU_MAX_DEVICES];  /* VTPU_DEVICE_MAP: card per ordinal */
};

static std::string strip(const char* s) {
  std::string v(s ? s : "");
  size_t a = v.find_first_not_of(" \t\n\r\f\v");
  size_t b = v.find_last_not_of(" \t\n\r\f\v");
  return a == std::string::npos ? "" : v.substr(a, b - a + 1);
}

/* envspec.parse_quantity:
 * ^\s*(\d+(?:\.\d+)?)\s*([kmgtKMGT]i?|)\s*[bB]?\s*$ -> int(float * mult) */
static bool parse_quantity(const char* s, uint64_t* out) {
  std::string v = strip(s);
  size_t i = 0, n = v.size();
  size_t d0 = i;
  while (i < n && isdigit((unsigned char)v[i])) i++;
  if (i == d0) return false;
  if (i < n && v[i] == '.') {
    size_t f0 = ++i;
    while (i < n && isdigit((unsigned char)v[i])) i++;
    if (i == f0) return false;
  }
  std::string number = v.substr(d0, i - d0);
  while (i < n && isspace((unsigned char)v[i])) i++;
  double mult = 1;
  if (i < n && strchr("kmgtKMGT", v[i])) {
    char c = (char)tolower((unsigned char)v[i++]);
    bool binary = i < n && v[i] == 'i';
    if (binary) i++;
    int e = c == 'k' ? 1 : c == 'm' ? 2 : c == 'g' ? 3 : 4;
    for (int k = 0; k < e; k++) mult *= binary ? 1024.0 : 1000.0;
  }
  while (i < n && isspace((unsigned char)v[i])) i++;
  if (i < n && (v[i] == 'b' || v[i] == 'B')) i++;
  while (i < n && isspace((unsigned char)v[i])) i++;
  if (i != n) return false;
  *out = (uint64_t)(strtod(number.c_str(), nullptr) * mult);
  return true;
}

/* Python's int() on a decimal string (signs, surrounding space). */
static bool parse_int(const char* s, long* out) {
  std::string v = strip(s);
  if (v.empty()) return false;
  char* end = nullptr;
  errno = 0;
  long x = strtol(v.c_str(), &end, 10);
  if (errno || *end != '\0' || !isdigit((unsigned char)v.back())) return false;
  *out = x;
  return true;
}

static bool parse_bool(const char* s) {
  std::string v = strip(s);
  std::transform(v.begin(), v.end(), v.begin(), ::tolower);
  return v == "true" || v == "1" || v == "yes" || v == "on";
}

static Quota parse_quota() {
  Quota q;
  static const char kHbm[] = "VTPU_DEVICE_HBM_LIMIT";
  const size_t nh = sizeof(kHbm) - 1;
  bool have_default = false, have[VTPU_MAX_DEVICES] = {};
  uint64_t def = 0;
  int max_ord = -1;
  for (char** e = environ; e && *e; e++) {
    const char* kv = *e;
    const char* eq = strchr(kv, '=');
    if (!eq || strncmp(kv, kHbm, nh) != 0) continue;
    std::string key(kv, eq - kv);
    uint64_t bytes = 0;
    if (key.size() == nh) {
      if (!parse_quantity(eq + 1, &bytes)) q.bad = true;
      have_default = true;
      def = bytes;
      continue;
    }
    if (key[nh] != '_') continue;
    long ord = 0;
    if (!parse_int(key.c_str() + nh + 1, &ord) || ord >= VTPU_MAX_DEVICES ||
        !parse_quantity(eq + 1, &bytes)) {
      q.bad = true;
      continue;
    }
    if (ord == -1) {  /* envspec keys the default as ordinal -1 */
      have_default = true;
      def = bytes;
    } else if (ord >= 0) {
      have[ord] = true;
      q.limits[ord] = bytes;
      if (ord > max_ord) max_ord = (int)ord;
    }
  }
  q.ndev = max_ord + 1 > 1 ? max_ord + 1 : 1;
  for (int i = 0; i < q.ndev; i++)
    if (!have[i]) q.limits[i] = have_default ? def : 0;
  q.any = have_default || max_ord >= 0;

  long v = 0;
  if (const char* s = getenv("VTPU_DEVICE_CORE_LIMIT")) {
    if (parse_int(s, &v))
      q.core_pct = (int32_t)std::max(0L, std::min(100L, v));
    else
      q.bad = true;
  }
  q.any = q.any || q.core_pct > 0;
  std::string pol = strip(getenv("VTPU_CORE_UTILIZATION_POLICY"));
  std::transform(pol.begin(), pol.end(), pol.begin(), ::toupper);
  q.policy = pol == "FORCE" ? POLICY_FORCE
             : pol == "DISABLE" ? POLICY_DISABLE : POLICY_DEFAULT;
  if (const char* s = getenv("VTPU_TASK_PRIORITY")) {
    if (parse_int(s, &v))
      q.priority = (int)v;
    else
      q.bad = true;
  }
  q.oversubscribe = parse_bool(getenv("VTPU_OVERSUBSCRIBE"));
  q.oom_killer = parse_bool(getenv("VTPU_ACTIVE_OOM_KILLER"));
  if (const char* s = getenv("VTPU_MIN_EXEC_COST_US")) {
    std::string c = strip(s);
    char* end = nullptr;
    double us = c.empty() ? 0 : strtod(c.c_str(), &end);
    if (!c.empty() && (*end != '\0' || us < 0))
      q.bad = true;
    else
      q.min_cost_us = (uint64_t)us;
  }
  const char* path = getenv("VTPU_DEVICE_MEMORY_SHARED_CACHE");
  q.region = path && *path ? path : "/tmp/vtpushr.cache";
  /* envspec.parse_device_map: "<i>:<uuid> ..."; a token without ':' or
   * with an ordinal int() rejects is an error. */
  std::string map = strip(getenv("VTPU_DEVICE_MAP"));
  for (size_t i = 0; i < map.size();) {
    size_t end = map.find_first_of(" \t\n\r\f\v", i);
    if (end == std::string::npos) end = map.size();
    std::string tok = map.substr(i, end - i);
    i = map.find_first_not_of(" \t\n\r\f\v", end);
    if (i == std::string::npos) i = map.size();
    size_t colon = tok.find(':');
    long ord = 0;
    if (colon == std::string::npos ||
        !parse_int(tok.substr(0, colon).c_str(), &ord)) {
      q.bad = true;
      continue;
    }
    if (ord >= 0 && ord < VTPU_MAX_DEVICES) q.uuids[ord] = tok.substr(colon + 1);
  }
  q.busy_dir = strip(getenv("VTPU_DEVICE_BUSY_DIR"));
  return q;
}

/* ------------------------------------------------------------------ */
/* state                                                              */
/* ------------------------------------------------------------------ */

/* Mirrored by shim/interposer.py:Stats. */
struct vtpu_cuda_stats {
  uint64_t launches;       /* kernel launches through the gate */
  uint64_t graph_launches; /* ... of which cuGraphLaunch */
  uint64_t gate_waits;     /* launches that waited for the bucket */
  uint64_t gate_ns;        /* time in the gate, waits included */
  uint64_t wait_ns;        /* ... of which waiting for the bucket */
  uint64_t refused;        /* allocations refused past the cap */
  uint64_t charged_bytes;  /* bytes charged to the region, live */
  uint64_t spilled_bytes;  /* managed bytes allocated past the cap, live */
  uint64_t booked_us;      /* device time the watcher booked */
  uint64_t debited_us;     /* ... of which debited from the bucket */
  uint64_t busy_ticks;     /* watcher ticks with work pending, per device */
  uint64_t shared_ticks;   /* ... while another process was busy too */
  uint64_t procaddr_hooks; /* cuGetProcAddress answers replaced */
  int32_t state;           /* STATE_* */
  int32_t meter;           /* 0 idle, 1 metering, -1 cannot meter */
  /* the parsed quota */
  int32_t ndev;
  int32_t core_pct;
  int32_t policy;
  int32_t priority;
  int32_t oversubscribe;
  int32_t oom_killer;
  uint64_t min_cost_us;
  uint64_t limits[VTPU_MAX_DEVICES];
};

struct Counters {
  std::atomic<uint64_t> launches{0}, graph_launches{0}, gate_waits{0},
      gate_ns{0}, wait_ns{0}, refused{0}, charged_bytes{0},
      spilled_bytes{0}, booked_us{0}, debited_us{0}, busy_ticks{0},
      shared_ticks{0}, procaddr_hooks{0};
};
static Counters C;

static Quota g_q;
static std::atomic<int> g_state{-1}; /* -1 until the first hooked call */
static vtpu_region* g_region = nullptr;
static std::mutex g_init_mu;
static std::atomic<bool> g_registered{false};

/* Parse the env and attach the region, once, at the first hooked call
 * (never in a constructor: the library is in every process of the
 * container).  Returns the state. */
static int state() {
  int s = g_state.load(std::memory_order_acquire);
  if (s >= 0) return s;
  std::lock_guard<std::mutex> lk(g_init_mu);
  s = g_state.load(std::memory_order_relaxed);
  if (s >= 0) return s;
  if (const char* lvl = getenv("VTPU_LOG_LEVEL")) g_log_level = atoi(lvl);
  g_q = parse_quota();
  if (!g_q.any && !g_q.bad) {
    s = STATE_OFF;
    LOG(3, "no quota env; forwarding everything");
  } else if (g_q.bad) {
    s = STATE_FAILCLOSED;
    LOG(0, "a VTPU_* quota value does not parse; REFUSING every "
        "allocation and launch rather than run unenforced");
  } else {
    int32_t pcts[VTPU_MAX_DEVICES];
    for (int i = 0; i < g_q.ndev; i++) pcts[i] = g_q.core_pct;
    g_region = vtpu_region_open(g_q.region.c_str(), g_q.ndev, g_q.limits,
                                pcts);
    if (g_region == nullptr) {
      s = STATE_FAILCLOSED;
      LOG(0, "cannot open the shared region %s (%s); REFUSING every "
          "allocation and launch rather than run unenforced",
          g_q.region.c_str(), strerror(errno));
    } else {
      s = STATE_ENFORCING;
      LOG(3, "region %s: %d device(s), limit[0]=%llu, core=%d%%",
          g_q.region.c_str(), g_q.ndev, (unsigned long long)g_q.limits[0],
          (int)g_q.core_pct);
    }
  }
  g_state.store(s, std::memory_order_release);
  return s;
}

/* Take a slot in the region (at the first CUDA call that charges or
 * launches; the NVML view only reads). */
static void enroll() {
  if (g_registered.load(std::memory_order_acquire)) return;
  std::lock_guard<std::mutex> lk(g_init_mu);
  if (g_registered.load(std::memory_order_relaxed)) return;
  vtpu_proc_register(g_region, 0);
  g_registered.store(true, std::memory_order_release);
}

static int region_dev(int dev) {
  return g_region && dev >= 0 && dev < vtpu_region_ndevices(g_region) ? dev
                                                                      : 0;
}

/* The current context's device as a region ordinal. */
static int current_dev() {
  resolve_reals(LIB_CUDA);
  CUdevice d = 0;
  fn_cuCtxGetDevice* f = R.cuCtxGetDevice.load(std::memory_order_acquire);
  if (f == nullptr || f(&d) != CUDA_SUCCESS) d = 0;
  return region_dev(d);
}

/* ------------------------------------------------------------------ */
/* memory                                                             */
/* ------------------------------------------------------------------ */

struct Charge {
  int dev;
  uint64_t bytes;
  bool managed;     /* spilled past the cap: allocated managed, uncharged */
};

static std::mutex g_mem_mu;
/* Heap-allocated and never destroyed: frees still arrive during exit. */
static auto* g_ptrs = new std::unordered_map<CUdeviceptr, Charge>();
static auto* g_handles =
    new std::unordered_map<CUmemGenericAllocationHandle, Charge>();
static auto* g_arrays = new std::unordered_map<CUarray, Charge>();
static auto* g_mipmaps = new std::unordered_map<CUmipmappedArray, Charge>();
static auto* g_nodes = new std::unordered_map<CUgraphNode, Charge>();

static CUresult oom(int dev, uint64_t bytes) {
  uint64_t freeb = 0, total = 0;
  vtpu_mem_info(g_region, dev, &freeb, &total);
  C.refused++;
  LOG(1, "vGPU device %d OOM: requested %llu bytes, quota %llu (free %llu)",
      dev, (unsigned long long)bytes, (unsigned long long)total,
      (unsigned long long)freeb);
  if (g_q.oom_killer) {
    fprintf(stderr, "[vtpu_cuda] active OOM killer: device %d over its "
            "quota\n", dev);
    kill(getpid(), SIGKILL);
  }
  return CUDA_ERROR_OUT_OF_MEMORY;
}

/* Charge `bytes` on the current device, run `alloc`, record the result
 * under `key` in `map`.  Past the cap: OOM, or a managed allocation when
 * `spill` is given (VTPU_OVERSUBSCRIBE, synchronous allocations only). */
template <class Key, class Alloc, class Spill>
static CUresult charged(std::unordered_map<Key, Charge>* map, Key* key,
                        int dev, uint64_t bytes, Alloc alloc, Spill spill) {
  if (vtpu_mem_acquire(g_region, dev, bytes, 0) != 0) {
    CUresult r = spill();
    if (r != CUDA_ERROR_NOT_SUPPORTED) {
      if (r == CUDA_SUCCESS) {
        std::lock_guard<std::mutex> lk(g_mem_mu);
        (*map)[*key] = Charge{dev, bytes, true};
        C.spilled_bytes += bytes;
      }
      return r;
    }
    return oom(dev, bytes);
  }
  CUresult r = alloc();
  if (r != CUDA_SUCCESS) {
    vtpu_mem_release(g_region, dev, bytes);
    return r;
  }
  C.charged_bytes += bytes;
  std::lock_guard<std::mutex> lk(g_mem_mu);
  (*map)[*key] = Charge{dev, bytes, false};
  return r;
}

static CUresult no_spill() { return CUDA_ERROR_NOT_SUPPORTED; }

template <class Key>
static void release(std::unordered_map<Key, Charge>* map, Key key) {
  Charge c{};
  {
    std::lock_guard<std::mutex> lk(g_mem_mu);
    auto it = map->find(key);
    if (it == map->end()) return;
    c = it->second;
    map->erase(it);
  }
  if (c.managed) {
    C.spilled_bytes -= c.bytes;
    return;
  }
  vtpu_mem_release(g_region, c.dev, c.bytes);
  C.charged_bytes -= c.bytes;
}

/* Memory entry points share one shape: forward when no quota is set,
 * refuse when it failed closed, else charge around the real call. */
#define MEM_PROLOGUE(forward)                              \
  int st_ = state();                                       \
  if (st_ == STATE_OFF) return forward;                    \
  if (st_ == STATE_FAILCLOSED) return CUDA_ERROR_NOT_PERMITTED; \
  enroll();

extern Hook g_hooks[];
enum HookId {
  H_cuGetProcAddress,
  H_cuGetProcAddress_v2,
  H_cuMemAlloc_v2,
  H_cuMemAllocPitch_v2,
  H_cuMemAllocManaged,
  H_cuMemAllocAsync,
  H_cuMemAllocAsync_ptsz,
  H_cuMemAllocFromPoolAsync,
  H_cuMemAllocFromPoolAsync_ptsz,
  H_cuMemCreate,
  H_cuMemFree_v2,
  H_cuMemFreeAsync,
  H_cuMemFreeAsync_ptsz,
  H_cuMemRelease,
  H_cuArrayCreate_v2,
  H_cuArray3DCreate_v2,
  H_cuMipmappedArrayCreate,
  H_cuArrayDestroy,
  H_cuMipmappedArrayDestroy,
  H_cuGraphAddMemAllocNode,
  H_cuGraphAddMemFreeNode,
  H_cuGraphAddNode,
  H_cuGraphAddNode_v2,
  H_cuGraphInstantiate,
  H_cuGraphInstantiate_v2,
  H_cuGraphInstantiateWithFlags,
  H_cuGraphInstantiateWithParams,
  H_cuGraphInstantiateWithParams_ptsz,
  H_cuGraphExecDestroy,
  H_cuGraphDestroy,
  H_cuMemGetInfo_v2,
  H_cuDeviceTotalMem_v2,
  H_cuLaunchKernel,
  H_cuLaunchKernel_ptsz,
  H_cuLaunchKernelEx,
  H_cuLaunchKernelEx_ptsz,
  H_cuLaunchCooperativeKernel,
  H_cuLaunchCooperativeKernel_ptsz,
  H_cuGraphLaunch,
  H_cuGraphLaunch_ptsz,
  H_nvmlDeviceGetMemoryInfo,
  H_nvmlDeviceGetMemoryInfo_v2,
  H_COUNT
};
#define REAL(id, type) real<type>(g_hooks[id])

EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytesize) {
  auto* f = REAL(H_cuMemAlloc_v2, fn_cuMemAlloc_v2);
  MEM_PROLOGUE(f(dptr, bytesize));
  if (dptr == nullptr || bytesize == 0) return f(dptr, bytesize);
  return charged(
      g_ptrs, dptr, current_dev(), bytesize,
      [&] { return f(dptr, bytesize); },
      [&] {
        if (!g_q.oversubscribe) return CUDA_ERROR_NOT_SUPPORTED;
        return R.cuMemAllocManaged.load()(dptr, bytesize,
                                          CU_MEM_ATTACH_GLOBAL);
      });
}

EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pPitch,
                                   size_t WidthInBytes, size_t Height,
                                   unsigned int ElementSizeBytes) {
  auto* f = REAL(H_cuMemAllocPitch_v2, fn_cuMemAllocPitch_v2);
  auto call = [&] {
    return f(dptr, pPitch, WidthInBytes, Height, ElementSizeBytes);
  };
  MEM_PROLOGUE(call());
  uint64_t est = (uint64_t)WidthInBytes * Height;
  if (dptr == nullptr || pPitch == nullptr || est == 0) return call();
  int dev = current_dev();
  CUresult r = charged(g_ptrs, dptr, dev, est, call, [&] {
    if (!g_q.oversubscribe) return CUDA_ERROR_NOT_SUPPORTED;
    *pPitch = WidthInBytes;
    return R.cuMemAllocManaged.load()(dptr, est, CU_MEM_ATTACH_GLOBAL);
  });
  if (r == CUDA_SUCCESS) {
    /* Settle the estimate to the padded size the driver chose (admitted
     * past the cap: the memory exists now). */
    uint64_t actual = (uint64_t)*pPitch * Height;
    std::lock_guard<std::mutex> lk(g_mem_mu);
    Charge& c = (*g_ptrs)[*dptr];
    if (!c.managed && actual > est) {
      vtpu_mem_acquire(g_region, dev, actual - est, 1);
      C.charged_bytes += actual - est;
      c.bytes = actual;
    }
  }
  return r;
}

EXPORT CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytesize,
                                  unsigned int flags) {
  auto* f = REAL(H_cuMemAllocManaged, fn_cuMemAllocManaged);
  MEM_PROLOGUE(f(dptr, bytesize, flags));
  if (dptr == nullptr || bytesize == 0) return f(dptr, bytesize, flags);
  return charged(g_ptrs, dptr, current_dev(), bytesize,
                 [&] { return f(dptr, bytesize, flags); }, no_spill);
}

static CUresult alloc_async(Hook& k, CUdeviceptr* dptr, size_t bytesize,
                            CUstream s) {
  auto* f = real<fn_cuMemAllocAsync>(k);
  MEM_PROLOGUE(f(dptr, bytesize, s));
  if (dptr == nullptr || bytesize == 0) return f(dptr, bytesize, s);
  return charged(g_ptrs, dptr, current_dev(), bytesize,
                 [&] { return f(dptr, bytesize, s); }, no_spill);
}
EXPORT CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytesize,
                                CUstream hStream) {
  return alloc_async(g_hooks[H_cuMemAllocAsync], dptr, bytesize, hStream);
}
EXPORT CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytesize,
                                     CUstream hStream) {
  return alloc_async(g_hooks[H_cuMemAllocAsync_ptsz], dptr, bytesize,
                     hStream);
}

static CUresult alloc_pool(Hook& k, CUdeviceptr* dptr, size_t bytesize,
                           CUmemoryPool pool, CUstream s) {
  auto* f = real<fn_cuMemAllocFromPoolAsync>(k);
  MEM_PROLOGUE(f(dptr, bytesize, pool, s));
  if (dptr == nullptr || bytesize == 0) return f(dptr, bytesize, pool, s);
  return charged(g_ptrs, dptr, current_dev(), bytesize,
                 [&] { return f(dptr, bytesize, pool, s); }, no_spill);
}
EXPORT CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytesize,
                                        CUmemoryPool pool, CUstream hStream) {
  return alloc_pool(g_hooks[H_cuMemAllocFromPoolAsync], dptr, bytesize, pool,
                    hStream);
}
EXPORT CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr,
                                             size_t bytesize,
                                             CUmemoryPool pool,
                                             CUstream hStream) {
  return alloc_pool(g_hooks[H_cuMemAllocFromPoolAsync_ptsz], dptr, bytesize,
                    pool, hStream);
}

/* Virtual memory management (PyTorch's expandable segments): physical
 * memory is created here, on the device the properties name. */
EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                            size_t size, const CUmemAllocationProp* prop,
                            unsigned long long flags) {
  auto* f = REAL(H_cuMemCreate, fn_cuMemCreate);
  MEM_PROLOGUE(f(handle, size, prop, flags));
  if (handle == nullptr || prop == nullptr || size == 0 ||
      prop->location.type != CU_MEM_LOCATION_TYPE_DEVICE)
    return f(handle, size, prop, flags);
  return charged(g_handles, handle, region_dev(prop->location.id), size,
                 [&] { return f(handle, size, prop, flags); }, no_spill);
}

static void freed(CUdeviceptr dptr);

EXPORT CUresult cuMemFree_v2(CUdeviceptr dptr) {
  CUresult r = REAL(H_cuMemFree_v2, fn_cuMemFree_v2)(dptr);
  if (r == CUDA_SUCCESS && g_state.load() == STATE_ENFORCING) freed(dptr);
  return r;
}

static CUresult free_async(Hook& k, CUdeviceptr dptr, CUstream s) {
  CUresult r = real<fn_cuMemFreeAsync>(k)(dptr, s);
  /* Stream-ordered: the memory returns to the pool in stream order; its
   * charge goes now. */
  if (r == CUDA_SUCCESS && g_state.load() == STATE_ENFORCING) freed(dptr);
  return r;
}
EXPORT CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream hStream) {
  return free_async(g_hooks[H_cuMemFreeAsync], dptr, hStream);
}
EXPORT CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream hStream) {
  return free_async(g_hooks[H_cuMemFreeAsync_ptsz], dptr, hStream);
}

EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  CUresult r = REAL(H_cuMemRelease, fn_cuMemRelease)(handle);
  if (r == CUDA_SUCCESS && g_state.load() == STATE_ENFORCING)
    release(g_handles, handle);
  return r;
}

/* ---- CUDA arrays ---------------------------------------------------- */

/* Bytes of one channel of an element of `f`.  A format not listed here
 * (packed, block-compressed and video formats) is charged as the widest
 * element a CUDA array holds, 16 bytes, so it is never under-charged. */
static uint64_t format_bytes(CUarray_format f) {
  switch (f) {
    case CU_AD_FORMAT_UNSIGNED_INT8:
    case CU_AD_FORMAT_SIGNED_INT8:
      return 1;
    case CU_AD_FORMAT_UNSIGNED_INT16:
    case CU_AD_FORMAT_SIGNED_INT16:
    case CU_AD_FORMAT_HALF:
      return 2;
    case CU_AD_FORMAT_UNSIGNED_INT32:
    case CU_AD_FORMAT_SIGNED_INT32:
    case CU_AD_FORMAT_FLOAT:
      return 4;
  }
  return 16;
}

/* The reference's compute_array_alloc_bytes (SURVEY §2.9c): width ×
 * height × depth × channels × format bytes, a 0 extent counting as 1,
 * summed over `levels` mip levels, each half the last in every extent
 * but the layers (or cube faces) of a layered array.  Saturates rather
 * than wraps, so an absurd descriptor is refused. */
static uint64_t array_bytes(const CUDA_ARRAY3D_DESCRIPTOR& d,
                            unsigned int levels) {
  const bool layered = d.Flags & (kArray3DLayered | kArray3DCubemap);
  uint64_t total = 0;
  for (unsigned int l = 0; l < std::max(1u, std::min(levels, 64u)); l++) {
    uint64_t extent[3] = {d.Width >> l, d.Height >> l,
                          layered ? d.Depth : d.Depth >> l};
    uint64_t n = format_bytes(d.Format) * std::max(1u, d.NumChannels);
    for (uint64_t e : extent)
      if (__builtin_mul_overflow(n, std::max<uint64_t>(e, 1), &n))
        return UINT64_MAX;
    if (__builtin_add_overflow(total, n, &total)) return UINT64_MAX;
  }
  return total;
}

template <class Call>
static CUresult create_array(CUarray* pHandle,
                             const CUDA_ARRAY3D_DESCRIPTOR& d, Call call) {
  MEM_PROLOGUE(call());
  if (pHandle == nullptr) return call();
  return charged(g_arrays, pHandle, current_dev(), array_bytes(d, 1), call,
                 no_spill);
}

EXPORT CUresult cuArrayCreate_v2(CUarray* pHandle,
                                 const CUDA_ARRAY_DESCRIPTOR* pAllocateArray) {
  auto* f = REAL(H_cuArrayCreate_v2, fn_cuArrayCreate_v2);
  auto call = [&] { return f(pHandle, pAllocateArray); };
  if (pAllocateArray == nullptr) return call();
  const CUDA_ARRAY_DESCRIPTOR& a = *pAllocateArray;
  return create_array(pHandle,
                      {a.Width, a.Height, 0, a.Format, a.NumChannels, 0},
                      call);
}

EXPORT CUresult cuArray3DCreate_v2(
    CUarray* pHandle, const CUDA_ARRAY3D_DESCRIPTOR* pAllocateArray) {
  auto* f = REAL(H_cuArray3DCreate_v2, fn_cuArray3DCreate_v2);
  auto call = [&] { return f(pHandle, pAllocateArray); };
  if (pAllocateArray == nullptr) return call();
  return create_array(pHandle, *pAllocateArray, call);
}

EXPORT CUresult cuMipmappedArrayCreate(
    CUmipmappedArray* pHandle,
    const CUDA_ARRAY3D_DESCRIPTOR* pMipmappedArrayDesc,
    unsigned int numMipmapLevels) {
  auto* f = REAL(H_cuMipmappedArrayCreate, fn_cuMipmappedArrayCreate);
  auto call = [&] { return f(pHandle, pMipmappedArrayDesc, numMipmapLevels); };
  MEM_PROLOGUE(call());
  if (pHandle == nullptr || pMipmappedArrayDesc == nullptr) return call();
  return charged(g_mipmaps, pHandle, current_dev(),
                 array_bytes(*pMipmappedArrayDesc, numMipmapLevels), call,
                 no_spill);
}

EXPORT CUresult cuArrayDestroy(CUarray hArray) {
  CUresult r = REAL(H_cuArrayDestroy, fn_cuArrayDestroy)(hArray);
  if (r == CUDA_SUCCESS && g_state.load() == STATE_ENFORCING)
    release(g_arrays, hArray);
  return r;
}

EXPORT CUresult cuMipmappedArrayDestroy(CUmipmappedArray hMipmappedArray) {
  CUresult r = REAL(H_cuMipmappedArrayDestroy,
                    fn_cuMipmappedArrayDestroy)(hMipmappedArray);
  if (r == CUDA_SUCCESS && g_state.load() == STATE_ENFORCING)
    release(g_mipmaps, hMipmappedArray);
  return r;
}

/* ---- graph memory nodes ---------------------------------------------- */

/* A memory node's allocation is made each time an executable graph made
 * from its graph is launched, and lives until a free node, cuMemFreeAsync
 * or cuMemFree frees it; destroying the graph or the executable graph
 * frees nothing.  So the node's bytesize is charged when the node is added
 * (refused past the cap) and held while its graph or any executable graph
 * instantiated from it lives.  When the last of them is destroyed the
 * charge goes, unless an allocation the node made may still be live (a
 * launch made it, and no free of its address was seen since): then the
 * charge passes to that address, and the free that ends the allocation
 * releases it.  The driver refuses to clone a graph with memory nodes or
 * to nest it as a child graph, so no other graph launches these nodes.
 * Allocations captured from a stream pass through cuMemAllocAsync and
 * cuMemFreeAsync at capture, and are charged between those calls. */
struct MemNode {
  CUdeviceptr dptr;
  bool live;  /* an allocation it made may be live now */
};
struct GraphMem {
  std::vector<CUgraphNode> allocs;  /* its memory nodes */
  std::vector<CUdeviceptr> frees;   /* addresses its free nodes free */
  int execs = 0;                    /* live executable graphs made from it */
  bool destroyed = false;
};
/* Under g_mem_mu: graphs with memory or free nodes, their memory nodes by
 * handle and by address, and the executable graphs made from them. */
static auto* g_graphs = new std::unordered_map<CUgraph, GraphMem>();
static auto* g_mem_nodes = new std::unordered_map<CUgraphNode, MemNode>();
static auto* g_node_at = new std::unordered_map<CUdeviceptr, CUgraphNode>();
static auto* g_execs = new std::unordered_map<CUgraphExec, CUgraph>();
/* Some memory node was charged: the graph hooks below have work to do. */
static std::atomic<bool> g_graph_mem{false};

/* Record a node of `graph` that allocates (`alloc`) or frees `dptr`. */
static void track_node(CUgraph graph, CUgraphNode node, CUdeviceptr dptr,
                       bool alloc) {
  std::lock_guard<std::mutex> lk(g_mem_mu);
  if (alloc) {
    (*g_graphs)[graph].allocs.push_back(node);
    (*g_mem_nodes)[node] = MemNode{dptr, false};
    (*g_node_at)[dptr] = node;
    g_graph_mem.store(true, std::memory_order_relaxed);
  } else if (g_node_at->count(dptr)) {
    (*g_graphs)[graph].frees.push_back(dptr);
  }
}

/* An allocation at `dptr` was freed outside any graph. */
static void freed(CUdeviceptr dptr) {
  release(g_ptrs, dptr);  /* a pointer's, or a graph allocation's passed on */
  if (!g_graph_mem.load(std::memory_order_relaxed)) return;
  std::lock_guard<std::mutex> lk(g_mem_mu);
  auto n = g_node_at->find(dptr);
  if (n != g_node_at->end()) (*g_mem_nodes)[n->second].live = false;
}

/* Under g_mem_mu: once `graph` and every executable graph made from it
 * are destroyed, drop them; returns the memory nodes whose charges go (the
 * others' passed to their addresses). */
static std::vector<CUgraphNode> retire_locked(CUgraph graph) {
  std::vector<CUgraphNode> gone;
  auto g = g_graphs->find(graph);
  if (g == g_graphs->end() || !g->second.destroyed || g->second.execs > 0)
    return gone;
  for (CUgraphNode n : g->second.allocs) {
    auto m = g_mem_nodes->find(n);
    if (m == g_mem_nodes->end()) continue;
    g_node_at->erase(m->second.dptr);
    auto c = g_nodes->find(n);
    if (m->second.live && c != g_nodes->end()) {
      (*g_ptrs)[m->second.dptr] = c->second;
      g_nodes->erase(c);
    } else {
      gone.push_back(n);
    }
    g_mem_nodes->erase(m);
  }
  g_graphs->erase(g);
  return gone;
}

template <class Call>
static CUresult add_alloc_node(CUgraphNode* node, CUgraph graph,
                               CUDA_MEM_ALLOC_NODE_PARAMS* p, Call call) {
  MEM_PROLOGUE(call());
  if (node == nullptr || p == nullptr || p->bytesize == 0) return call();
  const CUmemLocation& at = p->poolProps.location;
  int dev = at.type == CU_MEM_LOCATION_TYPE_DEVICE ? region_dev(at.id)
                                                   : current_dev();
  CUresult r = charged(g_nodes, node, dev, p->bytesize, call, no_spill);
  if (r == CUDA_SUCCESS) track_node(graph, *node, p->dptr, true);
  return r;
}

EXPORT CUresult cuGraphAddMemAllocNode(CUgraphNode* phGraphNode,
                                       CUgraph hGraph,
                                       const CUgraphNode* dependencies,
                                       size_t numDependencies,
                                       CUDA_MEM_ALLOC_NODE_PARAMS* nodeParams) {
  auto* f = REAL(H_cuGraphAddMemAllocNode, fn_cuGraphAddMemAllocNode);
  return add_alloc_node(phGraphNode, hGraph, nodeParams, [&] {
    return f(phGraphNode, hGraph, dependencies, numDependencies, nodeParams);
  });
}

EXPORT CUresult cuGraphAddMemFreeNode(CUgraphNode* phGraphNode,
                                      CUgraph hGraph,
                                      const CUgraphNode* dependencies,
                                      size_t numDependencies,
                                      CUdeviceptr dptr) {
  CUresult r = REAL(H_cuGraphAddMemFreeNode, fn_cuGraphAddMemFreeNode)(
      phGraphNode, hGraph, dependencies, numDependencies, dptr);
  if (r == CUDA_SUCCESS && g_graph_mem.load(std::memory_order_relaxed))
    track_node(hGraph, *phGraphNode, dptr, false);
  return r;
}

/* cuGraphAddNode[_v2]: a memory node is charged as above, a free node
 * recorded. */
template <class Call>
static CUresult add_node(CUgraphNode* node, CUgraph graph,
                         CUgraphNodeParams* p, Call call) {
  if (p != nullptr && p->type == CU_GRAPH_NODE_TYPE_MEM_ALLOC)
    return add_alloc_node(node, graph, &p->alloc, call);
  CUresult r = call();
  if (r == CUDA_SUCCESS && p != nullptr &&
      p->type == CU_GRAPH_NODE_TYPE_MEM_FREE &&
      g_graph_mem.load(std::memory_order_relaxed))
    track_node(graph, *node, p->free.dptr, false);
  return r;
}

EXPORT CUresult cuGraphAddNode(CUgraphNode* phGraphNode, CUgraph hGraph,
                               const CUgraphNode* dependencies,
                               size_t numDependencies,
                               CUgraphNodeParams* nodeParams) {
  auto* f = REAL(H_cuGraphAddNode, fn_cuGraphAddNode);
  return add_node(phGraphNode, hGraph, nodeParams, [&] {
    return f(phGraphNode, hGraph, dependencies, numDependencies, nodeParams);
  });
}

EXPORT CUresult cuGraphAddNode_v2(CUgraphNode* phGraphNode, CUgraph hGraph,
                                  const CUgraphNode* dependencies,
                                  const CUgraphEdgeData* dependencyData,
                                  size_t numDependencies,
                                  CUgraphNodeParams* nodeParams) {
  auto* f = REAL(H_cuGraphAddNode_v2, fn_cuGraphAddNode_v2);
  return add_node(phGraphNode, hGraph, nodeParams, [&] {
    return f(phGraphNode, hGraph, dependencies, dependencyData,
             numDependencies, nodeParams);
  });
}

/* An executable graph was made from `graph`: its memory nodes stay
 * charged while it lives. */
static CUresult instantiated(CUresult r, CUgraphExec* exec, CUgraph graph) {
  if (r != CUDA_SUCCESS || exec == nullptr ||
      !g_graph_mem.load(std::memory_order_relaxed))
    return r;
  std::lock_guard<std::mutex> lk(g_mem_mu);
  auto g = g_graphs->find(graph);
  if (g != g_graphs->end()) {
    g->second.execs++;
    (*g_execs)[*exec] = graph;
  }
  return r;
}

EXPORT CUresult cuGraphInstantiate(CUgraphExec* phGraphExec, CUgraph hGraph,
                                   CUgraphNode* phErrorNode, char* logBuffer,
                                   size_t bufferSize) {
  return instantiated(REAL(H_cuGraphInstantiate, fn_cuGraphInstantiate_v2)(
                          phGraphExec, hGraph, phErrorNode, logBuffer,
                          bufferSize),
                      phGraphExec, hGraph);
}

EXPORT CUresult cuGraphInstantiate_v2(CUgraphExec* phGraphExec,
                                      CUgraph hGraph,
                                      CUgraphNode* phErrorNode,
                                      char* logBuffer, size_t bufferSize) {
  return instantiated(
      REAL(H_cuGraphInstantiate_v2, fn_cuGraphInstantiate_v2)(
          phGraphExec, hGraph, phErrorNode, logBuffer, bufferSize),
      phGraphExec, hGraph);
}

EXPORT CUresult cuGraphInstantiateWithFlags(CUgraphExec* phGraphExec,
                                            CUgraph hGraph,
                                            unsigned long long flags) {
  return instantiated(
      REAL(H_cuGraphInstantiateWithFlags, fn_cuGraphInstantiateWithFlags)(
          phGraphExec, hGraph, flags),
      phGraphExec, hGraph);
}

static CUresult instantiate_params(Hook& k, CUgraphExec* exec, CUgraph graph,
                                   CUDA_GRAPH_INSTANTIATE_PARAMS* params) {
  return instantiated(
      real<fn_cuGraphInstantiateWithParams>(k)(exec, graph, params), exec,
      graph);
}
EXPORT CUresult cuGraphInstantiateWithParams(
    CUgraphExec* phGraphExec, CUgraph hGraph,
    CUDA_GRAPH_INSTANTIATE_PARAMS* instantiateParams) {
  return instantiate_params(g_hooks[H_cuGraphInstantiateWithParams],
                            phGraphExec, hGraph, instantiateParams);
}
EXPORT CUresult cuGraphInstantiateWithParams_ptsz(
    CUgraphExec* phGraphExec, CUgraph hGraph,
    CUDA_GRAPH_INSTANTIATE_PARAMS* instantiateParams) {
  return instantiate_params(g_hooks[H_cuGraphInstantiateWithParams_ptsz],
                            phGraphExec, hGraph, instantiateParams);
}

/* After a launch of `exec`: its graph's memory nodes have live
 * allocations, and the addresses its free nodes free have none. */
static void graph_launched(CUgraphExec exec) {
  std::vector<CUdeviceptr> passed;
  {
    std::lock_guard<std::mutex> lk(g_mem_mu);
    auto e = g_execs->find(exec);
    if (e == g_execs->end()) return;
    const GraphMem& g = (*g_graphs)[e->second];
    for (CUgraphNode n : g.allocs) (*g_mem_nodes)[n].live = true;
    for (CUdeviceptr d : g.frees) {
      auto n = g_node_at->find(d);
      if (n != g_node_at->end())
        (*g_mem_nodes)[n->second].live = false;
      else
        passed.push_back(d);
    }
  }
  for (CUdeviceptr d : passed) release(g_ptrs, d);
}

EXPORT CUresult cuGraphExecDestroy(CUgraphExec hGraphExec) {
  CUresult r = REAL(H_cuGraphExecDestroy, fn_cuGraphExecDestroy)(hGraphExec);
  if (r != CUDA_SUCCESS || !g_graph_mem.load(std::memory_order_relaxed))
    return r;
  std::vector<CUgraphNode> gone;
  {
    std::lock_guard<std::mutex> lk(g_mem_mu);
    auto e = g_execs->find(hGraphExec);
    if (e == g_execs->end()) return r;
    CUgraph graph = e->second;
    g_execs->erase(e);
    (*g_graphs)[graph].execs--;
    gone = retire_locked(graph);
  }
  for (CUgraphNode n : gone) release(g_nodes, n);
  return r;
}

EXPORT CUresult cuGraphDestroy(CUgraph hGraph) {
  CUresult r = REAL(H_cuGraphDestroy, fn_cuGraphDestroy)(hGraph);
  if (r != CUDA_SUCCESS || !g_graph_mem.load(std::memory_order_relaxed))
    return r;
  std::vector<CUgraphNode> gone;
  {
    std::lock_guard<std::mutex> lk(g_mem_mu);
    auto g = g_graphs->find(hGraph);
    if (g == g_graphs->end()) return r;
    g->second.destroyed = true;
    gone = retire_locked(hGraph);
  }
  for (CUgraphNode n : gone) release(g_nodes, n);
  return r;
}

/* ---- the quota view ---------------------------------------------- */

/* (free, total) of region ordinal `dev` when it has a cap; false when
 * the real answer stands. */
static bool quota_view(int dev, uint64_t* freeb, uint64_t* total) {
  if (state() != STATE_ENFORCING) return false;
  return vtpu_mem_info(g_region, region_dev(dev), freeb, total) == 0 &&
         *total > 0;
}

EXPORT CUresult cuMemGetInfo_v2(size_t* free, size_t* total) {
  CUresult r = REAL(H_cuMemGetInfo_v2, fn_cuMemGetInfo_v2)(free, total);
  uint64_t f = 0, t = 0;
  if (r == CUDA_SUCCESS && quota_view(current_dev(), &f, &t)) {
    if (free) *free = f;
    if (total) *total = t;
  }
  return r;
}

EXPORT CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev) {
  CUresult r = REAL(H_cuDeviceTotalMem_v2, fn_cuDeviceTotalMem_v2)(bytes, dev);
  uint64_t f = 0, t = 0;
  if (r == CUDA_SUCCESS && bytes && quota_view(dev, &f, &t)) *bytes = t;
  return r;
}

static int nvml_index(nvmlDevice_t device) {
  static std::atomic<fn_nvmlDeviceGetIndex*> get{nullptr};
  fn_nvmlDeviceGetIndex* f = get.load(std::memory_order_acquire);
  if (f == nullptr) {
    f = (fn_nvmlDeviceGetIndex*)real_of(LIB_NVML, "nvmlDeviceGetIndex");
    get.store(f, std::memory_order_release);
  }
  unsigned int i = 0;
  return f && f(device, &i) == NVML_SUCCESS ? (int)i : 0;
}

EXPORT nvmlReturn_t nvmlDeviceGetMemoryInfo(nvmlDevice_t device,
                                            nvmlMemory_t* memory) {
  nvmlReturn_t r = REAL(H_nvmlDeviceGetMemoryInfo,
                        fn_nvmlDeviceGetMemoryInfo)(device, memory);
  uint64_t f = 0, t = 0;
  if (r == NVML_SUCCESS && memory && quota_view(nvml_index(device), &f, &t)) {
    memory->total = t;
    memory->free = f;
    memory->used = t - f;
  }
  return r;
}

EXPORT nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t device,
                                               nvmlMemory_v2_t* memory) {
  nvmlReturn_t r = REAL(H_nvmlDeviceGetMemoryInfo_v2,
                        fn_nvmlDeviceGetMemoryInfo_v2)(device, memory);
  uint64_t f = 0, t = 0;
  if (r == NVML_SUCCESS && memory && quota_view(nvml_index(device), &f, &t)) {
    memory->total = t;
    memory->reserved = 0;
    memory->free = f;
    memory->used = t - f;
  }
  return r;
}

/* ------------------------------------------------------------------ */
/* compute: the launch gate and the device-time watcher               */
/* ------------------------------------------------------------------ */

static bool core_limited() {
  return g_q.core_pct > 0 && g_q.core_pct < 100 &&
         g_q.policy != POLICY_DISABLE;
}

/* DEFAULT gates only while another process shares the region; the probe
 * sweeps under the region lock, so it is trusted for 100 ms. */
static bool gating_active() {
  if (!core_limited()) return false;
  if (g_q.policy == POLICY_FORCE) return true;
  static std::atomic<uint64_t> next_probe{0};
  static std::atomic<bool> cached{true};
  uint64_t now = mono_ns();
  uint64_t next = next_probe.load(std::memory_order_relaxed);
  if (now >= next &&
      next_probe.compare_exchange_strong(next, now + 100000000ull))
    cached.store(vtpu_region_active_procs(g_region) > 1,
                 std::memory_order_relaxed);
  return cached.load(std::memory_order_relaxed);
}

/* The streams this process launched on, with their context and region
 * device: the watcher asks each whether it has work pending.  Appended
 * under g_streams_mu, read without it up to g_nstreams. */
struct Stream {
  CUcontext ctx;
  CUstream stream;
  int dev;
};
static const int kMaxStreams = 64;
static Stream g_streams[kMaxStreams];
static std::atomic<int> g_nstreams{0};
static std::mutex g_streams_mu;

/* A per-thread default stream (CU_STREAM_PER_THREAD, or stream 0 through
 * a _ptsz entry point) is a different stream in every thread, and the
 * watcher's own thread cannot query the launching thread's.  Each
 * (thread, context) that launches on one takes a slot here with an event,
 * recorded on its stream after every launch while the meter can run; the
 * watcher queries the event, which any thread may.  A thread gives its
 * slots back, and their events are destroyed, when it exits.  Under
 * g_streams_mu, the watcher included; a slot's owner reads its own slot
 * without it. */
struct PerThread {
  bool used;
  CUcontext ctx;
  int dev;
  CUevent event;  /* null while its owner creates it */
};
static const int kMaxPerThread = 64;
static PerThread g_pt[kMaxPerThread];

/* This thread's slots, one per context it launched in on its per-thread
 * default stream (-1: that stream is gated but not metered). */
struct ThreadSlots {
  static const int kMax = 8;
  CUcontext ctx[kMax];
  int slot[kMax];
  int n = 0;
  ~ThreadSlots();
};
static thread_local ThreadSlots t_slots;

ThreadSlots::~ThreadSlots() {
  CUevent events[kMax];
  int k = 0;
  {
    std::lock_guard<std::mutex> lk(g_streams_mu);
    for (int i = 0; i < n; i++) {
      if (slot[i] < 0) continue;
      events[k++] = g_pt[slot[i]].event;
      g_pt[slot[i]] = PerThread{};
    }
  }
  n = 0;
  fn_cuEventDestroy_v2* destroy = R.cuEventDestroy.load();
  for (int i = 0; i < k; i++)
    if (destroy && events[i]) destroy(events[i]);
}

/* Per device: the bucket was in debt at the watcher's last booking
 * (launches wait it out), and the floor charged since that booking. */
static std::atomic<bool> g_debt[VTPU_MAX_DEVICES];
static std::atomic<uint64_t> g_floor_us[VTPU_MAX_DEVICES];

static void start_watcher();

static bool per_thread_stream(CUstream s, bool ptsz) {
  return (uintptr_t)s == kStreamPerThread || (ptsz && s == nullptr);
}

/* Take a slot for this thread's per-thread default stream in `ctx`, then
 * make its event.  Returns the slot, or -1 when none is free or no event
 * can be made. */
static int take_slot(CUcontext ctx) {
  fn_cuEventCreate* create = R.cuEventCreate.load(std::memory_order_acquire);
  if (create == nullptr || R.cuEventRecord.load() == nullptr ||
      R.cuEventQuery.load() == nullptr) {
    LOG(1, "no events: per-thread default streams are gated but not "
        "metered");
    return -1;
  }
  int slot = -1;
  int dev = current_dev();
  {
    std::lock_guard<std::mutex> lk(g_streams_mu);
    for (int i = 0; i < kMaxPerThread && slot < 0; i++)
      if (!g_pt[i].used) {
        g_pt[i] = PerThread{true, ctx, dev, nullptr};
        slot = i;
      }
  }
  if (slot < 0) {
    LOG(1, "more than %d per-thread default streams: later ones are gated "
        "but not metered", kMaxPerThread);
    return -1;
  }
  CUevent ev = nullptr;
  bool made = create(&ev, CU_EVENT_DISABLE_TIMING) == CUDA_SUCCESS;
  std::lock_guard<std::mutex> lk(g_streams_mu);
  if (!made) {
    g_pt[slot] = PerThread{};
    LOG(1, "no event for a per-thread default stream: its launches are "
        "gated but not metered");
    return -1;
  }
  g_pt[slot].event = ev;
  return slot;
}

/* This thread's slot for its per-thread default stream in `ctx`, taken at
 * its first launch there; -1 when that stream is not metered. */
static int per_thread_slot(CUcontext ctx) {
  ThreadSlots& t = t_slots;
  for (int i = 0; i < t.n; i++)
    if (t.ctx[i] == ctx) return t.slot[i];
  if (t.n == ThreadSlots::kMax) {
    static std::atomic<bool> said{false};
    if (!said.exchange(true))
      LOG(1, "a thread in more than %d contexts: its per-thread default "
          "streams in the others are gated but not metered", t.n);
    return -1;
  }
  t.ctx[t.n] = ctx;
  t.slot[t.n] = take_slot(ctx);
  return t.slot[t.n++];
}

/* The region device of a launch on `stream` (`ptsz`: through a _ptsz
 * entry point); a stream seen for the first time is registered for the
 * watcher.  `*ev` is the event to record after the launch, or null. */
static int launch_dev(CUstream stream, bool ptsz, CUevent* ev) {
  resolve_reals(LIB_CUDA);
  CUcontext ctx = nullptr;
  fn_cuCtxGetCurrent* cur = R.cuCtxGetCurrent.load(std::memory_order_acquire);
  if (cur == nullptr || cur(&ctx) != CUDA_SUCCESS) ctx = nullptr;
  if (per_thread_stream(stream, ptsz)) {
    int i = per_thread_slot(ctx);
    start_watcher();
    if (i < 0) return current_dev();
    *ev = g_pt[i].event;
    return g_pt[i].dev;
  }
  int n = g_nstreams.load(std::memory_order_acquire);
  for (int i = 0; i < n; i++)
    if (g_streams[i].ctx == ctx && g_streams[i].stream == stream)
      return g_streams[i].dev;
  std::lock_guard<std::mutex> lk(g_streams_mu);
  n = g_nstreams.load(std::memory_order_relaxed);
  for (int i = 0; i < n; i++)
    if (g_streams[i].ctx == ctx && g_streams[i].stream == stream)
      return g_streams[i].dev;
  int dev = current_dev();
  if (n < kMaxStreams) {
    g_streams[n] = Stream{ctx, stream, dev};
    g_nstreams.store(n + 1, std::memory_order_release);
  } else if (n == kMaxStreams) {
    LOG(1, "more than %d streams: later ones are gated but not metered",
        kMaxStreams);
    g_nstreams.store(n + 1, std::memory_order_release);
  }
  start_watcher();
  return dev;
}

/* Pass the gate before a launch on `stream`.  `*ev` is set to the event to
 * record after the launch (a per-thread default stream's), or left null. */
static CUresult gate(CUstream stream, bool graph, bool ptsz, CUevent* ev) {
  C.launches++;
  if (graph) C.graph_launches++;
  int st = state();
  if (st == STATE_OFF) return CUDA_SUCCESS;
  if (st == STATE_FAILCLOSED) return CUDA_ERROR_NOT_PERMITTED;
  uint64_t t0 = mono_ns();
  enroll();
  int dev = launch_dev(stream, ptsz, ev);
  /* With a floor each launch is charged it up front, as vtpu charges each
   * execute; otherwise a launch only waits while the watcher last saw the
   * bucket in debt, and costs no region call. */
  uint64_t cost = g_q.min_cost_us;
  if (cost ? gating_active() : g_debt[dev].load(std::memory_order_relaxed)) {
    uint64_t t1 = mono_ns();
    if (vtpu_rate_acquire(g_region, dev, cost, g_q.priority) != 0) {
      vtpu_rate_block(g_region, dev, cost, g_q.priority);
      C.gate_waits++;
      C.wait_ns += mono_ns() - t1;
    }
    if (cost) g_floor_us[dev] += cost;
    g_debt[dev].store(false, std::memory_order_relaxed);
  }
  C.gate_ns += mono_ns() - t0;
  return CUDA_SUCCESS;
}

/* Book `us` of device time that this process ran on `dev` since the last
 * booking, of which `floor_us` was charged up front at launch. */
static void book(int dev, uint64_t us, uint64_t floor_us) {
  if (us) {
    vtpu_busy_add(g_region, dev, us);
    C.booked_us += us;
  }
  if (us > floor_us && gating_active()) {
    vtpu_rate_adjust(g_region, dev, (int64_t)(us - floor_us));
    C.debited_us += us - floor_us;
  }
}

/* ---- the watcher: the process's own device time -------------------- */

/* Every tick the watcher asks each stream the process launched on
 * whether work is pending (cuStreamQuery).  A device with pending work is
 * busy for that tick.  The card time-slices between processes, so while
 * k processes are busy on it each runs about 1/k of the tick: the
 * processes on a card publish their busy ticks in a busy file (one slot
 * each) and each books tick/k.  Every kTicksPerBooking ticks the watcher
 * books that time into the duty counter and, while gating, into the
 * bucket, and reads the bucket back: below 1 µs, launches wait.
 *
 * The busy file is the card's own, <VTPU_DEVICE_BUSY_DIR>/<uuid>.busy
 * with the card's UUID from VTPU_DEVICE_MAP: every Allocate gives its pod
 * a private region, and only a file per card lets two pods granted halves
 * of one card see each other.  The daemon creates each card's file at
 * full size and Allocate mounts only the granted cards' files, so the
 * interposer opens one as it finds it: no symlink is followed, nothing is
 * created, resized or re-permissioned, and a file that is not a regular
 * one of the full size is refused.  Without the directory (a tenant
 * started by hand), or when the card's file is refused, it is
 * <region>.busy, which the region's own processes share.
 *
 * A slot belongs to a random 64-bit token, never to a pid: pids of other
 * containers collide with this one's and kill() cannot reach them.  Its
 * holder refreshes a heartbeat (CLOCK_MONOTONIC, one clock for the whole
 * host) every tick; a slot whose heartbeat is older than kSlotLeaseNs, a
 * few idle ticks, is free, and claiming one is a compare-and-swap of that
 * heartbeat.
 *
 * A query is not free: on the card measured, queries every 2 ms slowed
 * the launching thread of a launch-bound tenant (PERF.md).  So the
 * watcher ticks every kTickNs only while the share gates, and every
 * kIdleTickNs otherwise, when what it books feeds only the duty counter.
 *
 * NVML's per-process utilisation (the reference's source) would give
 * each process's device time directly, but the card's driver may not
 * offer it, and NVML names processes by their host pid, which a
 * container does not see (both so where this was measured, PERF.md).
 * A per-thread default stream is queried through its event (Stream). */
static const uint64_t kTickNs = 2000000ull;
static const uint64_t kIdleTickNs = 50000000ull;
static const uint64_t kSlotLeaseNs = 4 * kIdleTickNs;
static const int kTicksPerBooking = 5;
static const int kBusySlots = VTPU_MAX_PROCS;

/* Mirrored by native/interposer_test.cc; a busy file is kBusySlots of
 * them (vtpu_cuda_busy_file_bytes). */
struct BusySlot {
  uint64_t owner;   /* the holder's token; 0 while free or being claimed */
  uint64_t beat_ns; /* the holder's last heartbeat; 0 once released */
  int32_t pid;      /* the holder's pid in its own namespace: information */
  int32_t pad;
  uint64_t until_ns[VTPU_MAX_DEVICES]; /* busy through (CLOCK_MONOTONIC) */
};

static std::atomic<int> g_meter{0};
static std::mutex g_watch_mu;
static std::condition_variable g_watch_cv;
static bool g_watch_stop = false;
static pthread_t g_watch_thread;
static std::atomic<bool> g_watch_started{false};

/* The busy files this process maps, and which file and column each
 * device uses.  The watcher thread alone touches them (and stop_watcher,
 * after joining it). */
struct BusyFile {
  BusySlot* slots;  /* kBusySlots, mapped; nullptr when unavailable */
  int mine;         /* this process's slot, -1 until it claims one */
};
static BusyFile g_busy[VTPU_MAX_DEVICES + 1];
static int g_busy_of[VTPU_MAX_DEVICES];  /* index into g_busy, -1: unopened */
static int g_col_of[VTPU_MAX_DEVICES];   /* the device's until_ns column */
static uint64_t g_token = 0;             /* this process's slot owner token */

static uint64_t new_token() {
  uint64_t t = 0;
  while (t == 0) {
    if (getrandom(&t, sizeof(t), 0) != (ssize_t)sizeof(t))
      t = mono_ns() ^ ((uint64_t)getpid() << 32) ^ (uint64_t)(uintptr_t)&t;
  }
  return t;
}

static void busy_reset() {
  for (int d = 0; d < VTPU_MAX_DEVICES; d++) g_busy_of[d] = -1;
  for (BusyFile& f : g_busy) f.mine = -1;
  g_token = new_token();
}

/* Map a busy file: the card's (`create` false) as the daemon made it,
 * or the region's, created here at first use. */
static BusySlot* map_busy_file(const std::string& path, bool create) {
  const size_t size = sizeof(BusySlot) * kBusySlots;
  int fd = create ? open(path.c_str(), O_RDWR | O_CREAT | O_CLOEXEC, 0666)
                  : open(path.c_str(), O_RDWR | O_NOFOLLOW | O_CLOEXEC);
  if (fd < 0) {
    LOG(1, "cannot open %s (%s)", path.c_str(), strerror(errno));
    return nullptr;
  }
  struct stat st;
  void* p = MAP_FAILED;
  if (fstat(fd, &st) != 0) {
    LOG(1, "cannot stat %s (%s)", path.c_str(), strerror(errno));
  } else if (create) {
    fchmod(fd, 0666);  /* every user's tenants share it (fails for a non-owner) */
    if ((size_t)st.st_size >= size || ftruncate(fd, (off_t)size) == 0)
      p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  } else if (!S_ISREG(st.st_mode) || (size_t)st.st_size < size) {
    LOG(1, "refusing %s: not a regular file of %zu bytes", path.c_str(), size);
  } else {
    p = mmap(nullptr, size, PROT_READ | PROT_WRITE, MAP_SHARED, fd, 0);
  }
  close(fd);
  if (p == MAP_FAILED) {
    LOG(1, "cannot map %s", path.c_str());
    return nullptr;
  }
  LOG(3, "busy file %s", path.c_str());
  return (BusySlot*)p;
}

static bool usable_name(const std::string& u) {
  return !u.empty() && u != "." && u != ".." &&
         u.find('/') == std::string::npos;
}

/* The busy file of region device `dev` and its column there: the card's
 * own file under VTPU_DEVICE_BUSY_DIR (column 0), else the region's
 * (column dev).  Opened at first use. */
static BusyFile* busy_file(int dev, int* col) {
  if (g_busy_of[dev] < 0) {
    const std::string& uuid = g_q.uuids[dev];
    if (!g_q.busy_dir.empty() && usable_name(uuid))
      g_busy[dev].slots =
          map_busy_file(g_q.busy_dir + "/" + uuid + ".busy", false);
    if (g_busy[dev].slots != nullptr) {
      g_busy_of[dev] = dev;
      g_col_of[dev] = 0;
    } else {
      if (!g_q.busy_dir.empty())
        LOG(1, "device %d has no usable card busy file: it meets only its "
            "region's processes", dev);
      g_busy_of[dev] = VTPU_MAX_DEVICES;
      g_col_of[dev] = dev;
      static bool mapped = false;
      if (!mapped) {
        g_busy[VTPU_MAX_DEVICES].slots =
            map_busy_file(g_q.region + ".busy", true);
        mapped = true;
      }
    }
  }
  *col = g_col_of[dev];
  return &g_busy[g_busy_of[dev]];
}

/* This process's slot in `f` with its heartbeat refreshed: the one it
 * holds, or a free one (never held, released, or its heartbeat lapsed). */
static BusySlot* claim_slot(BusyFile* f, uint64_t now) {
  if (f->slots == nullptr) return nullptr;
  if (f->mine >= 0) {
    BusySlot* s = &f->slots[f->mine];
    if (__atomic_load_n(&s->owner, __ATOMIC_ACQUIRE) == g_token) {
      __atomic_store_n(&s->beat_ns, now, __ATOMIC_RELEASE);
      return s;
    }
    f->mine = -1;  /* it lapsed and another process took it */
  }
  for (int i = 0; i < kBusySlots; i++) {
    BusySlot* s = &f->slots[i];
    uint64_t beat = __atomic_load_n(&s->beat_ns, __ATOMIC_ACQUIRE);
    if (beat != 0 && beat + kSlotLeaseNs >= now) continue;
    if (!__atomic_compare_exchange_n(&s->beat_ns, &beat, now, false,
                                     __ATOMIC_ACQ_REL, __ATOMIC_RELAXED))
      continue;
    for (int d = 0; d < VTPU_MAX_DEVICES; d++)
      __atomic_store_n(&s->until_ns[d], 0, __ATOMIC_RELAXED);
    __atomic_store_n(&s->pid, (int32_t)getpid(), __ATOMIC_RELAXED);
    __atomic_store_n(&s->owner, g_token, __ATOMIC_RELEASE);
    f->mine = i;
    return s;
  }
  return nullptr;
}

/* Give back every slot this process holds (at exit). */
static void release_slots() {
  for (BusyFile& f : g_busy) {
    if (f.slots == nullptr || f.mine < 0) continue;
    BusySlot* s = &f.slots[f.mine];
    for (int d = 0; d < VTPU_MAX_DEVICES; d++)
      __atomic_store_n(&s->until_ns[d], 0, __ATOMIC_RELAXED);
    uint64_t me = g_token;
    if (__atomic_compare_exchange_n(&s->owner, &me, 0, false,
                                    __ATOMIC_ACQ_REL, __ATOMIC_RELAXED))
      __atomic_store_n(&s->beat_ns, 0, __ATOMIC_RELEASE);
    f.mine = -1;
  }
}

/* Publish that this process is busy on `dev` through the next ticks, and
 * count the processes busy on its card now (this one included). */
static int busy_share(int dev, uint64_t now, uint64_t tick) {
  int col = 0;
  BusyFile* f = busy_file(dev, &col);
  BusySlot* mine = claim_slot(f, now);
  if (mine == nullptr) return 1;
  __atomic_store_n(&mine->until_ns[col], now + 2 * tick, __ATOMIC_RELAXED);
  int k = 0;
  for (int i = 0; i < kBusySlots; i++)
    if (__atomic_load_n(&f->slots[i].until_ns[col], __ATOMIC_RELAXED) > now)
      k++;
  return k > 0 ? k : 1;
}

static void* watch_main(void*) {
  resolve_reals(LIB_CUDA);
  fn_cuStreamQuery* query = R.cuStreamQuery.load();
  fn_cuEventQuery* query_event = R.cuEventQuery.load();
  fn_cuCtxSetCurrent* set_ctx = R.cuCtxSetCurrent.load();
  if (!query || !set_ctx) {
    g_meter.store(-1);
    LOG(0, "cuStreamQuery unavailable: device time is not metered");
    return nullptr;
  }
  g_meter.store(1);
  busy_reset();
  uint64_t own_ns[VTPU_MAX_DEVICES] = {};
  uint64_t last = mono_ns();
  CUcontext current = nullptr;
  std::unique_lock<std::mutex> lk(g_watch_mu);
  for (int tick = 1; !g_watch_stop; tick++) {
    const uint64_t tick_ns = gating_active() ? kTickNs : kIdleTickNs;
    g_watch_cv.wait_for(lk, std::chrono::nanoseconds(tick_ns));
    if (g_watch_stop) break;
    lk.unlock();
    uint64_t now = mono_ns(), dt = now - last;
    last = now;
    bool busy[VTPU_MAX_DEVICES] = {}, seen[VTPU_MAX_DEVICES] = {};
    auto poll = [&](CUcontext ctx, int dev, CUstream stream, CUevent ev) {
      seen[dev] = true;
      if (busy[dev]) return;
      if (ctx != current && set_ctx(ctx) == CUDA_SUCCESS) current = ctx;
      busy[dev] = (ev ? query_event(ev) : query(stream)) ==
                  CUDA_ERROR_NOT_READY;
    };
    int n = std::min(g_nstreams.load(std::memory_order_acquire), kMaxStreams);
    for (int i = 0; i < n; i++)
      poll(g_streams[i].ctx, g_streams[i].dev, g_streams[i].stream, nullptr);
    {
      std::lock_guard<std::mutex> slk(g_streams_mu);
      for (const PerThread& p : g_pt)
        if (p.used && p.event) poll(p.ctx, p.dev, nullptr, p.event);
    }
    for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
      if (!seen[d]) continue;
      if (!busy[d]) {  /* hold the slot: heartbeat only */
        int col = 0;
        claim_slot(busy_file(d, &col), now);
        continue;
      }
      int k = busy_share(d, now, tick_ns);
      own_ns[d] += dt / k;
      C.busy_ticks++;
      if (k > 1) C.shared_ticks++;
    }
    if (tick % kTicksPerBooking == 0) {
      for (int d = 0; d < VTPU_MAX_DEVICES; d++) {
        if (!seen[d]) continue;
        book(d, own_ns[d] / 1000, g_floor_us[d].exchange(0));
        own_ns[d] %= 1000;
        g_debt[d].store(g_q.priority > 0 && gating_active() &&
                            vtpu_rate_level(g_region, d) < 1,
                        std::memory_order_relaxed);
      }
    }
    lk.lock();
  }
  return nullptr;
}

static void stop_watcher() {
  if (!g_watch_started.exchange(false)) return;
  {
    std::lock_guard<std::mutex> lk(g_watch_mu);
    g_watch_stop = true;
  }
  g_watch_cv.notify_all();
  pthread_join(g_watch_thread, nullptr);
  release_slots();
}

static void start_watcher() {
  if (g_watch_started.exchange(true)) return;
  sigset_t all, old;
  sigfillset(&all);
  pthread_sigmask(SIG_SETMASK, &all, &old);  /* signals stay with the app */
  int rc = pthread_create(&g_watch_thread, nullptr, watch_main, nullptr);
  pthread_sigmask(SIG_SETMASK, &old, nullptr);
  if (rc != 0) {
    g_meter.store(-1);
    LOG(0, "cannot start the device-time watcher (%s)", strerror(rc));
    return;
  }
  /* Join before the CUDA runtime's own exit handlers tear the context
   * down (they were registered earlier, so they run later). */
  atexit(stop_watcher);
}

/* A forked child shares no thread, stream or allocation with its parent,
 * and takes its own slot in the region; a lock another thread held at
 * the fork is re-made unlocked. */
static void after_fork_child() {
  new (&g_init_mu) std::mutex();
  new (&g_mem_mu) std::mutex();
  new (&g_streams_mu) std::mutex();
  new (&g_watch_mu) std::mutex();
  new (&g_watch_cv) std::condition_variable();
  g_registered.store(false);
  g_watch_started.store(false);
  g_watch_stop = false;
  g_nstreams.store(0);
  for (PerThread& p : g_pt) p = PerThread{};
  t_slots.n = 0;
  g_ptrs = new std::unordered_map<CUdeviceptr, Charge>();
  g_handles = new std::unordered_map<CUmemGenericAllocationHandle, Charge>();
  g_arrays = new std::unordered_map<CUarray, Charge>();
  g_mipmaps = new std::unordered_map<CUmipmappedArray, Charge>();
  g_nodes = new std::unordered_map<CUgraphNode, Charge>();
  g_graphs = new std::unordered_map<CUgraph, GraphMem>();
  g_mem_nodes = new std::unordered_map<CUgraphNode, MemNode>();
  g_node_at = new std::unordered_map<CUdeviceptr, CUgraphNode>();
  g_execs = new std::unordered_map<CUgraphExec, CUgraph>();
  g_graph_mem.store(false);
  C.charged_bytes = 0;
  C.spilled_bytes = 0;
}
__attribute__((constructor)) static void install_fork_handler() {
  /* Registers a handler only: no env is read and nothing is opened. */
  pthread_atfork(nullptr, nullptr, after_fork_child);
}

/* ---- launch entry points ----------------------------------------- */

#define LAUNCH_PARAMS                                                     \
  CUfunction f, unsigned int gx, unsigned int gy, unsigned int gz,        \
      unsigned int bx, unsigned int by, unsigned int bz, unsigned int shm, \
      CUstream s
#define LAUNCH_ARGS f, gx, gy, gz, bx, by, bz, shm, s

/* After a launch on a per-thread default stream: mark its end with the
 * thread's event, for the watcher to query (unless metering cannot run). */
static CUresult launched(CUresult r, CUevent ev) {
  if (r == CUDA_SUCCESS && ev != nullptr &&
      g_meter.load(std::memory_order_relaxed) >= 0)
    R.cuEventRecord.load(std::memory_order_relaxed)(
        ev, (CUstream)kStreamPerThread);
  return r;
}

static CUresult launch(Hook& k, bool ptsz, LAUNCH_PARAMS, void** params,
                       void** extra) {
  CUevent ev = nullptr;
  CUresult g = gate(s, false, ptsz, &ev);
  if (g != CUDA_SUCCESS) return g;
  return launched(real<fn_cuLaunchKernel>(k)(LAUNCH_ARGS, params, extra), ev);
}
EXPORT CUresult cuLaunchKernel(LAUNCH_PARAMS, void** params, void** extra) {
  return launch(g_hooks[H_cuLaunchKernel], false, LAUNCH_ARGS, params, extra);
}
EXPORT CUresult cuLaunchKernel_ptsz(LAUNCH_PARAMS, void** params,
                                    void** extra) {
  return launch(g_hooks[H_cuLaunchKernel_ptsz], true, LAUNCH_ARGS, params,
                extra);
}

static CUresult launch_coop(Hook& k, bool ptsz, LAUNCH_PARAMS,
                            void** params) {
  CUevent ev = nullptr;
  CUresult g = gate(s, false, ptsz, &ev);
  if (g != CUDA_SUCCESS) return g;
  return launched(real<fn_cuLaunchCooperativeKernel>(k)(LAUNCH_ARGS, params),
                  ev);
}
EXPORT CUresult cuLaunchCooperativeKernel(LAUNCH_PARAMS, void** params) {
  return launch_coop(g_hooks[H_cuLaunchCooperativeKernel], false,
                     LAUNCH_ARGS, params);
}
EXPORT CUresult cuLaunchCooperativeKernel_ptsz(LAUNCH_PARAMS,
                                               void** params) {
  return launch_coop(g_hooks[H_cuLaunchCooperativeKernel_ptsz], true,
                     LAUNCH_ARGS, params);
}

static CUresult launch_ex(Hook& k, bool ptsz, const CUlaunchConfig* config,
                          CUfunction f, void** params, void** extra) {
  CUevent ev = nullptr;
  CUresult g = gate(config ? config->hStream : nullptr, false, ptsz, &ev);
  if (g != CUDA_SUCCESS) return g;
  return launched(real<fn_cuLaunchKernelEx>(k)(config, f, params, extra), ev);
}
EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig* config, CUfunction f,
                                 void** params, void** extra) {
  return launch_ex(g_hooks[H_cuLaunchKernelEx], false, config, f, params,
                   extra);
}
EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* config,
                                      CUfunction f, void** params,
                                      void** extra) {
  return launch_ex(g_hooks[H_cuLaunchKernelEx_ptsz], true, config, f, params,
                   extra);
}

static CUresult graph_launch(Hook& k, bool ptsz, CUgraphExec g, CUstream s) {
  CUevent ev = nullptr;
  CUresult r = gate(s, true, ptsz, &ev);
  if (r != CUDA_SUCCESS) return r;
  r = launched(real<fn_cuGraphLaunch>(k)(g, s), ev);
  if (r == CUDA_SUCCESS && g_graph_mem.load(std::memory_order_relaxed))
    graph_launched(g);
  return r;
}
EXPORT CUresult cuGraphLaunch(CUgraphExec hGraphExec, CUstream hStream) {
  return graph_launch(g_hooks[H_cuGraphLaunch], false, hGraphExec, hStream);
}
EXPORT CUresult cuGraphLaunch_ptsz(CUgraphExec hGraphExec, CUstream hStream) {
  return graph_launch(g_hooks[H_cuGraphLaunch_ptsz], true, hGraphExec,
                      hStream);
}

/* ------------------------------------------------------------------ */
/* symbol resolution                                                  */
/* ------------------------------------------------------------------ */

/* Replace the driver's answer by the wrapper when it is the real address
 * of a hooked function. */
static void substitute(void** pfn) {
  if (pfn == nullptr || *pfn == nullptr) return;
  resolve_reals(LIB_CUDA);
  for (size_t i = 0; i < g_nhooks; i++) {
    Hook& k = g_hooks[i];
    if (k.lib == LIB_CUDA &&
        k.real.load(std::memory_order_acquire) == *pfn) {
      *pfn = k.wrapper;
      C.procaddr_hooks++;
      return;
    }
  }
}

EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                    int cudaVersion, cuuint64_t flags,
                                    CUdriverProcAddressQueryResult* status) {
  CUresult r = REAL(H_cuGetProcAddress_v2, fn_cuGetProcAddress_v2)(
      symbol, pfn, cudaVersion, flags, status);
  if (r == CUDA_SUCCESS) substitute(pfn);
  return r;
}

EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                 int cudaVersion, cuuint64_t flags) {
  CUresult r = REAL(H_cuGetProcAddress, fn_cuGetProcAddress)(
      symbol, pfn, cudaVersion, flags);
  if (r == CUDA_SUCCESS) substitute(pfn);
  return r;
}

/* dlsym(RTLD_NEXT, name) as the CALLER would see it: the first object
 * after the caller's in load order that defines `name`.  Forwarding
 * RTLD_NEXT as is would search after this library instead, and hand an
 * interposing caller its own definition back. */
static void* next_after(const void* caller, const char* name) {
  Dl_info info;
  struct link_map* lm = nullptr;
  if (!dladdr1(caller, &info, (void**)&lm, RTLD_DL_LINKMAP) || !lm)
    return real_dlsym()(RTLD_NEXT, name);
  for (struct link_map* m = lm->l_next; m; m = m->l_next) {
    /* A proper handle for each object (the vdso's map is none). */
    void* h = m->l_name && *m->l_name
                  ? dlopen(m->l_name, RTLD_LAZY | RTLD_NOLOAD)
                  : nullptr;
    if (h == nullptr) continue;
    void* p = real_dlsym()(h, name);
    dlclose(h);
    struct link_map* owner = nullptr;
    if (p && dladdr1(p, &info, (void**)&owner, RTLD_DL_LINKMAP) &&
        owner == m)
      return p;
  }
  return nullptr;
}

EXPORT void* dlsym(void* handle, const char* name) noexcept {
  if (strncmp(name, "cu", 2) == 0 || strncmp(name, "nvml", 4) == 0) {
    if (Hook* k = hook_named(name)) {
      /* A wrapper is handed out only when the real function exists. */
      void* p = handle == RTLD_NEXT
                    ? next_after(__builtin_return_address(0), name)
                    : real_dlsym()(handle, name);
      if (p != nullptr) {
        void* expected = nullptr;
        k->real.compare_exchange_strong(expected, p);
        return k->wrapper;
      }
      return nullptr;
    }
  }
  if (handle == RTLD_NEXT)
    return next_after(__builtin_return_address(0), name);
  return real_dlsym()(handle, name);
}

#define HOOK(lib, name) {#name, lib, (void*)&name, {nullptr}}
Hook g_hooks[H_COUNT] = {
    HOOK(LIB_CUDA, cuGetProcAddress),
    HOOK(LIB_CUDA, cuGetProcAddress_v2),
    HOOK(LIB_CUDA, cuMemAlloc_v2),
    HOOK(LIB_CUDA, cuMemAllocPitch_v2),
    HOOK(LIB_CUDA, cuMemAllocManaged),
    HOOK(LIB_CUDA, cuMemAllocAsync),
    HOOK(LIB_CUDA, cuMemAllocAsync_ptsz),
    HOOK(LIB_CUDA, cuMemAllocFromPoolAsync),
    HOOK(LIB_CUDA, cuMemAllocFromPoolAsync_ptsz),
    HOOK(LIB_CUDA, cuMemCreate),
    HOOK(LIB_CUDA, cuMemFree_v2),
    HOOK(LIB_CUDA, cuMemFreeAsync),
    HOOK(LIB_CUDA, cuMemFreeAsync_ptsz),
    HOOK(LIB_CUDA, cuMemRelease),
    HOOK(LIB_CUDA, cuArrayCreate_v2),
    HOOK(LIB_CUDA, cuArray3DCreate_v2),
    HOOK(LIB_CUDA, cuMipmappedArrayCreate),
    HOOK(LIB_CUDA, cuArrayDestroy),
    HOOK(LIB_CUDA, cuMipmappedArrayDestroy),
    HOOK(LIB_CUDA, cuGraphAddMemAllocNode),
    HOOK(LIB_CUDA, cuGraphAddMemFreeNode),
    HOOK(LIB_CUDA, cuGraphAddNode),
    HOOK(LIB_CUDA, cuGraphAddNode_v2),
    HOOK(LIB_CUDA, cuGraphInstantiate),
    HOOK(LIB_CUDA, cuGraphInstantiate_v2),
    HOOK(LIB_CUDA, cuGraphInstantiateWithFlags),
    HOOK(LIB_CUDA, cuGraphInstantiateWithParams),
    HOOK(LIB_CUDA, cuGraphInstantiateWithParams_ptsz),
    HOOK(LIB_CUDA, cuGraphExecDestroy),
    HOOK(LIB_CUDA, cuGraphDestroy),
    HOOK(LIB_CUDA, cuMemGetInfo_v2),
    HOOK(LIB_CUDA, cuDeviceTotalMem_v2),
    HOOK(LIB_CUDA, cuLaunchKernel),
    HOOK(LIB_CUDA, cuLaunchKernel_ptsz),
    HOOK(LIB_CUDA, cuLaunchKernelEx),
    HOOK(LIB_CUDA, cuLaunchKernelEx_ptsz),
    HOOK(LIB_CUDA, cuLaunchCooperativeKernel),
    HOOK(LIB_CUDA, cuLaunchCooperativeKernel_ptsz),
    HOOK(LIB_CUDA, cuGraphLaunch),
    HOOK(LIB_CUDA, cuGraphLaunch_ptsz),
    HOOK(LIB_NVML, nvmlDeviceGetMemoryInfo),
    HOOK(LIB_NVML, nvmlDeviceGetMemoryInfo_v2),
};
const size_t g_nhooks = H_COUNT;

/* ------------------------------------------------------------------ */
/* identity and statistics                                            */
/* ------------------------------------------------------------------ */

EXPORT const char* vtpu_cuda_interposer_ident(void) {
  return "vtpu_cuda interposer 1";
}

/* The size of a card's busy file: the daemon stages each at this size
 * (plugin/grant.py BUSY_FILE_BYTES, held to it by a test), and the
 * watcher refuses a shorter one. */
EXPORT size_t vtpu_cuda_busy_file_bytes(void) {
  return sizeof(BusySlot) * kBusySlots;
}

EXPORT int vtpu_cuda_interposer_stats(vtpu_cuda_stats* out, size_t size) {
  if (out == nullptr || size != sizeof(vtpu_cuda_stats)) return -1;
  memset(out, 0, sizeof(*out));
  out->launches = C.launches;
  out->graph_launches = C.graph_launches;
  out->gate_waits = C.gate_waits;
  out->gate_ns = C.gate_ns;
  out->wait_ns = C.wait_ns;
  out->refused = C.refused;
  out->charged_bytes = C.charged_bytes;
  out->spilled_bytes = C.spilled_bytes;
  out->booked_us = C.booked_us;
  out->debited_us = C.debited_us;
  out->busy_ticks = C.busy_ticks;
  out->shared_ticks = C.shared_ticks;
  out->procaddr_hooks = C.procaddr_hooks;
  out->state = g_state.load();
  out->meter = g_meter.load();
  if (out->state >= 0) {
    out->ndev = g_q.ndev;
    out->core_pct = g_q.core_pct;
    out->policy = g_q.policy;
    out->priority = g_q.priority;
    out->oversubscribe = g_q.oversubscribe;
    out->oom_killer = g_q.oom_killer;
    out->min_cost_us = g_q.min_cost_us;
    memcpy(out->limits, g_q.limits, sizeof(out->limits));
  }
  return 0;
}
