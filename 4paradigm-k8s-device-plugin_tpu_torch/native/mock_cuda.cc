/* mock_cuda.cc — a stand-in for the CUDA driver and NVML, so the
 * interposer runs and is tested on a machine with no card.
 *
 * Built twice (ops/_build.py):
 *   -DMOCK_LIB_CUDA  libmockcuda, soname libcuda.so.1
 *   -DMOCK_LIB_NVML  libmocknvml, soname libnvidia-ml.so.1
 * with -Wl,-Bsymbolic, so the mock's own references (the table its
 * cuGetProcAddress answers from) bind to its own functions, as the real
 * driver's do, and never to the interposer's exports of the same names.
 *
 * The CUDA mock keeps a device timeline: each launch queues MOCK_KERNEL_US
 * of work (default 0) behind the device's earlier work, cuCtxSynchronize
 * sleeps until the device is idle, and cuStreamQuery reports
 * CUDA_ERROR_NOT_READY until the stream's last launch has run.  So the
 * busy time the interposer's watcher books is scripted by MOCK_KERNEL_US
 * and by when the program launches.  Streams are told apart in one way
 * only, as the driver does: a launch on a thread's per-thread default
 * stream (CU_STREAM_PER_THREAD, or stream 0 through a _ptsz entry point)
 * is that thread's, and a query of CU_STREAM_PER_THREAD sees the calling
 * thread's stream; every other stream handle is one shared stream.  An
 * event recorded on a stream (cuEventRecord) is pending until the
 * stream's work at that moment has run, for a query from any thread.
 *
 * CUDA arrays and mipmapped arrays are allocations of the device's memory
 * too; graph memory nodes get addresses only (see cuGraphAddMemAllocNode).
 *
 * Also set by env: MOCK_CUDA_DEVICES (default 1), MOCK_CUDA_MEM bytes per
 * device (default 80 GiB).  The current device is a thread's context:
 * cuCtxSetCurrent((CUcontext)(uintptr_t)(ordinal + 1)).
 *
 * Mock-only helpers (no driver has them): mockRealAddress(name) — the
 * mock's own function of an exported name; mockCalls(name) — calls into
 * it so far; mockIsManaged(ptr); mockUsedBytes(dev), which the NVML mock
 * reports.
 *
 * The NVML mock also enumerates its MOCK_CUDA_DEVICES cards as discovery
 * sees them (discovery/nvml.py): "NVIDIA H100 80GB HBM3", UUID
 * GPU-mock-<i>, bus 0000:<0x18+i>:00.0, minor i, NUMA node 0 for the
 * first half and 1 for the rest.  MOCK_NVML_MIG=1 turns MIG on with 7
 * instances of 1g.10gb a card (MIG-mock-<i>-<j>, 16 SMs, 9856 MiB).
 * MOCK_NVML_LINKS=pairs joins cards 2k and 2k+1 over NVLink only (default:
 * every pair, as NVSwitch does); other pairs meet at a NUMA node or
 * across the system.  Critical XID events are scripted by
 * MOCK_NVML_XID_FILE: each line "<card> <xid>" is one event, delivered by
 * nvmlEventSetWait_v2 once.
 */
#include <dlfcn.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <time.h>
#include <unistd.h>

#include <algorithm>
#include <atomic>
#include <map>
#include <mutex>
#include <set>
#include <string>
#include <vector>

#include "cuda_abi.h"

using namespace vtpu_abi;

#define EXPORT extern "C" __attribute__((visibility("default")))

static uint64_t wall_us() {
  struct timespec ts;
  clock_gettime(CLOCK_REALTIME, &ts);
  return (uint64_t)ts.tv_sec * 1000000ull + (uint64_t)ts.tv_nsec / 1000ull;
}

static uint64_t env_u64(const char* name, uint64_t def) {
  const char* s = getenv(name);
  return s && *s ? strtoull(s, nullptr, 10) : def;
}

#ifdef MOCK_LIB_CUDA

/* ---- state -------------------------------------------------------------- */

struct Alloc {
  int dev;
  uint64_t bytes;
  bool managed;
};

static std::mutex g_mu;
static std::map<uint64_t, Alloc> g_allocs;        /* pointers and handles */
static uint64_t g_next = 0x100000000ull;
static uint64_t g_busy_until[16];                /* every stream */
static uint64_t g_shared_until[16];              /* the shared stream */
static thread_local uint64_t t_per_thread_until; /* this thread's stream */
static std::map<std::string, uint64_t> g_calls;
static thread_local int t_dev = 0;

static int ndev() { return (int)std::min<uint64_t>(env_u64("MOCK_CUDA_DEVICES", 1), 16); }
static uint64_t dev_mem() { return env_u64("MOCK_CUDA_MEM", 80ull << 30); }

static void called(const char* name) {
  std::lock_guard<std::mutex> lk(g_mu);
  g_calls[name]++;
}

static uint64_t used_on(int dev) {
  uint64_t u = 0;
  for (auto& kv : g_allocs)
    if (kv.second.dev == dev && !kv.second.managed) u += kv.second.bytes;
  return u;
}

static CUresult do_alloc(const char* name, unsigned long long* out,
                         size_t bytes,
                         int dev, bool managed) {
  called(name);
  if (out == nullptr) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lk(g_mu);
  if (!managed && used_on(dev) + bytes > dev_mem())
    return CUDA_ERROR_OUT_OF_MEMORY;
  *out = g_next;
  g_next += (bytes + 0xffff) & ~0xffffull;
  g_allocs[*out] = Alloc{dev, bytes, managed};
  return CUDA_SUCCESS;
}

static std::set<uint64_t> g_node_addrs;  /* graph memory nodes' addresses */

static CUresult do_free(const char* name, uint64_t key) {
  called(name);
  std::lock_guard<std::mutex> lk(g_mu);
  return g_allocs.erase(key) || g_node_addrs.count(key)
             ? CUDA_SUCCESS
             : CUDA_ERROR_INVALID_VALUE;
}

static bool per_thread(CUstream s, bool ptsz) {
  return (uintptr_t)s == kStreamPerThread || (ptsz && s == nullptr);
}

/* When the work queued so far on stream `s` (of this thread) ends. */
static uint64_t stream_until(CUstream s) {
  return per_thread(s, false) ? t_per_thread_until : g_shared_until[t_dev];
}

static CUresult do_launch(const char* name, CUstream s, bool ptsz) {
  called(name);
  uint64_t k = env_u64("MOCK_KERNEL_US", 0);
  if (k == 0) return CUDA_SUCCESS;
  std::lock_guard<std::mutex> lk(g_mu);
  uint64_t end = std::max(wall_us(), g_busy_until[t_dev]) + k;
  g_busy_until[t_dev] = end;
  (per_thread(s, ptsz) ? t_per_thread_until : g_shared_until[t_dev]) = end;
  return CUDA_SUCCESS;
}

/* ---- the driver API ----------------------------------------------------- */

EXPORT CUresult cuInit(unsigned int) {
  called("cuInit");
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceGetCount(int* count) {
  called("cuDeviceGetCount");
  *count = ndev();
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxGetDevice(CUdevice* device) {
  called("cuCtxGetDevice");
  *device = t_dev;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxGetCurrent(CUcontext* pctx) {
  called("cuCtxGetCurrent");
  *pctx = (CUcontext)(uintptr_t)(t_dev + 1);
  return CUDA_SUCCESS;
}

/* Unhooked by the interposer. */
EXPORT CUresult cuCtxSetCurrent(CUcontext ctx) {
  called("cuCtxSetCurrent");
  int d = (int)(uintptr_t)ctx - 1;
  if (d < 0 || d >= ndev()) return CUDA_ERROR_INVALID_CONTEXT;
  t_dev = d;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuCtxSynchronize(void) {
  called("cuCtxSynchronize");
  uint64_t until;
  {
    std::lock_guard<std::mutex> lk(g_mu);
    until = g_busy_until[t_dev];
  }
  uint64_t now = wall_us();
  if (until > now) usleep((useconds_t)(until - now));
  return CUDA_SUCCESS;
}

EXPORT CUresult cuStreamQuery(CUstream s) {
  called("cuStreamQuery");
  std::lock_guard<std::mutex> lk(g_mu);
  return stream_until(s) > wall_us() ? CUDA_ERROR_NOT_READY : CUDA_SUCCESS;
}

/* An event is the time its stream's work ends, as of its last record. */
EXPORT CUresult cuEventCreate(CUevent* e, unsigned int) {
  called("cuEventCreate");
  if (e == nullptr) return CUDA_ERROR_INVALID_VALUE;
  *e = (CUevent) new uint64_t(0);
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventDestroy_v2(CUevent e) {
  called("cuEventDestroy_v2");
  if (e == nullptr) return CUDA_ERROR_INVALID_VALUE;
  delete (uint64_t*)e;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventRecord(CUevent e, CUstream s) {
  called("cuEventRecord");
  if (e == nullptr) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lk(g_mu);
  *(uint64_t*)e = stream_until(s);
  return CUDA_SUCCESS;
}

EXPORT CUresult cuEventQuery(CUevent e) {
  called("cuEventQuery");
  if (e == nullptr) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lk(g_mu);
  return *(uint64_t*)e > wall_us() ? CUDA_ERROR_NOT_READY : CUDA_SUCCESS;
}

/* cuMemAlloc of CUDA < 3.2: 32-bit sizes; never hooked. */
EXPORT CUresult cuMemAlloc(unsigned int* dptr, unsigned int bytesize) {
  unsigned long long p = 0;
  CUresult r = do_alloc("cuMemAlloc", &p, bytesize, t_dev, false);
  if (r == CUDA_SUCCESS) *dptr = (unsigned int)p;
  return r;
}

EXPORT CUresult cuMemAlloc_v2(CUdeviceptr* dptr, size_t bytesize) {
  return do_alloc("cuMemAlloc_v2", dptr, bytesize, t_dev, false);
}

EXPORT CUresult cuMemAllocPitch_v2(CUdeviceptr* dptr, size_t* pPitch,
                                   size_t WidthInBytes, size_t Height,
                                   unsigned int) {
  size_t pitch = (WidthInBytes + 511) & ~(size_t)511;
  CUresult r = do_alloc("cuMemAllocPitch_v2", dptr, pitch * Height, t_dev,
                        false);
  if (r == CUDA_SUCCESS) *pPitch = pitch;
  return r;
}

EXPORT CUresult cuMemAllocManaged(CUdeviceptr* dptr, size_t bytesize,
                                  unsigned int) {
  return do_alloc("cuMemAllocManaged", dptr, bytesize, t_dev, true);
}

EXPORT CUresult cuMemAllocAsync(CUdeviceptr* dptr, size_t bytesize,
                                CUstream) {
  return do_alloc("cuMemAllocAsync", dptr, bytesize, t_dev, false);
}
EXPORT CUresult cuMemAllocAsync_ptsz(CUdeviceptr* dptr, size_t bytesize,
                                     CUstream) {
  return do_alloc("cuMemAllocAsync_ptsz", dptr, bytesize, t_dev, false);
}
EXPORT CUresult cuMemAllocFromPoolAsync(CUdeviceptr* dptr, size_t bytesize,
                                        CUmemoryPool, CUstream) {
  return do_alloc("cuMemAllocFromPoolAsync", dptr, bytesize, t_dev, false);
}
EXPORT CUresult cuMemAllocFromPoolAsync_ptsz(CUdeviceptr* dptr,
                                             size_t bytesize, CUmemoryPool,
                                             CUstream) {
  return do_alloc("cuMemAllocFromPoolAsync_ptsz", dptr, bytesize, t_dev,
                  false);
}

EXPORT CUresult cuMemCreate(CUmemGenericAllocationHandle* handle,
                            size_t size, const CUmemAllocationProp* prop,
                            unsigned long long) {
  if (prop == nullptr) return CUDA_ERROR_INVALID_VALUE;
  bool device = prop->location.type == CU_MEM_LOCATION_TYPE_DEVICE;
  return do_alloc("cuMemCreate", handle, size,
                  device ? prop->location.id : 0, !device);
}

EXPORT CUresult cuMemFree_v2(CUdeviceptr dptr) {
  return do_free("cuMemFree_v2", dptr);
}
EXPORT CUresult cuMemFreeAsync(CUdeviceptr dptr, CUstream) {
  return do_free("cuMemFreeAsync", dptr);
}
EXPORT CUresult cuMemFreeAsync_ptsz(CUdeviceptr dptr, CUstream) {
  return do_free("cuMemFreeAsync_ptsz", dptr);
}
EXPORT CUresult cuMemRelease(CUmemGenericAllocationHandle handle) {
  return do_free("cuMemRelease", handle);
}

/* Arrays take width x height x depth x channels x 4 bytes here (the
 * interposer sizes them itself). */
static uint64_t mock_array_bytes(const CUDA_ARRAY3D_DESCRIPTOR* d) {
  return std::max<size_t>(d->Width, 1) * std::max<size_t>(d->Height, 1) *
         std::max<size_t>(d->Depth, 1) * std::max(d->NumChannels, 1u) * 4;
}

EXPORT CUresult cuArrayCreate_v2(CUarray* h, const CUDA_ARRAY_DESCRIPTOR* d) {
  if (d == nullptr) return CUDA_ERROR_INVALID_VALUE;
  CUDA_ARRAY3D_DESCRIPTOR d3 = {d->Width, d->Height, 0, d->Format,
                                d->NumChannels, 0};
  return do_alloc("cuArrayCreate_v2", (unsigned long long*)h,
                  mock_array_bytes(&d3), t_dev, false);
}
EXPORT CUresult cuArray3DCreate_v2(CUarray* h,
                                   const CUDA_ARRAY3D_DESCRIPTOR* d) {
  if (d == nullptr) return CUDA_ERROR_INVALID_VALUE;
  return do_alloc("cuArray3DCreate_v2", (unsigned long long*)h,
                  mock_array_bytes(d), t_dev, false);
}
EXPORT CUresult cuMipmappedArrayCreate(CUmipmappedArray* h,
                                       const CUDA_ARRAY3D_DESCRIPTOR* d,
                                       unsigned int levels) {
  if (d == nullptr || levels == 0) return CUDA_ERROR_INVALID_VALUE;
  return do_alloc("cuMipmappedArrayCreate", (unsigned long long*)h,
                  2 * mock_array_bytes(d), t_dev, false);
}
EXPORT CUresult cuArrayDestroy(CUarray a) {
  return do_free("cuArrayDestroy", (uint64_t)a);
}
EXPORT CUresult cuMipmappedArrayDestroy(CUmipmappedArray a) {
  return do_free("cuMipmappedArrayDestroy", (uint64_t)a);
}

/* A graph is any handle.  A memory node gets an address when it is added
 * and a node handle of its own; the mock allocates nothing for it (the
 * driver allocates at each launch, which only the interposer's ledger
 * follows here), and cuMemFree[Async] of the address succeeds.  An
 * executable graph is a fresh handle. */
static uint64_t g_next_handle = 0x7000;

static CUgraphNode new_handle() {
  std::lock_guard<std::mutex> lk(g_mu);
  return (CUgraphNode)(uintptr_t)(g_next_handle++);
}

static CUresult mem_node(const char* name, CUgraphNode* node,
                         CUDA_MEM_ALLOC_NODE_PARAMS* p) {
  called(name);
  if (node == nullptr || p == nullptr) return CUDA_ERROR_INVALID_VALUE;
  std::lock_guard<std::mutex> lk(g_mu);
  p->dptr = g_next;
  g_next += (p->bytesize + 0xffff) & ~0xffffull;
  g_node_addrs.insert(p->dptr);
  *node = (CUgraphNode)(uintptr_t)(g_next_handle++);
  return CUDA_SUCCESS;
}

EXPORT CUresult cuGraphAddMemAllocNode(CUgraphNode* node, CUgraph,
                                       const CUgraphNode*, size_t,
                                       CUDA_MEM_ALLOC_NODE_PARAMS* p) {
  return mem_node("cuGraphAddMemAllocNode", node, p);
}
EXPORT CUresult cuGraphAddMemFreeNode(CUgraphNode* node, CUgraph,
                                      const CUgraphNode*, size_t,
                                      CUdeviceptr) {
  called("cuGraphAddMemFreeNode");
  if (node == nullptr) return CUDA_ERROR_INVALID_VALUE;
  *node = new_handle();
  return CUDA_SUCCESS;
}
EXPORT CUresult cuGraphAddNode(CUgraphNode* node, CUgraph,
                               const CUgraphNode*, size_t,
                               CUgraphNodeParams* p) {
  if (p != nullptr && p->type == CU_GRAPH_NODE_TYPE_MEM_ALLOC)
    return mem_node("cuGraphAddNode", node, &p->alloc);
  called("cuGraphAddNode");
  if (node == nullptr || p == nullptr) return CUDA_ERROR_INVALID_VALUE;
  *node = new_handle();
  return CUDA_SUCCESS;
}
EXPORT CUresult cuGraphAddNode_v2(CUgraphNode* node, CUgraph graph,
                                  const CUgraphNode* deps,
                                  const CUgraphEdgeData*, size_t n,
                                  CUgraphNodeParams* p) {
  called("cuGraphAddNode_v2");
  return cuGraphAddNode(node, graph, deps, n, p);
}
EXPORT CUresult cuGraphDestroy(CUgraph) {
  called("cuGraphDestroy");
  return CUDA_SUCCESS;
}

static CUresult instantiate(const char* name, CUgraphExec* exec) {
  called(name);
  if (exec == nullptr) return CUDA_ERROR_INVALID_VALUE;
  *exec = (CUgraphExec)new_handle();
  return CUDA_SUCCESS;
}
EXPORT CUresult cuGraphInstantiate(CUgraphExec* exec, CUgraph, CUgraphNode*,
                                   char*, size_t) {
  return instantiate("cuGraphInstantiate", exec);
}
EXPORT CUresult cuGraphInstantiate_v2(CUgraphExec* exec, CUgraph,
                                      CUgraphNode*, char*, size_t) {
  return instantiate("cuGraphInstantiate_v2", exec);
}
EXPORT CUresult cuGraphInstantiateWithFlags(CUgraphExec* exec, CUgraph,
                                            unsigned long long) {
  return instantiate("cuGraphInstantiateWithFlags", exec);
}
EXPORT CUresult cuGraphInstantiateWithParams(CUgraphExec* exec, CUgraph,
                                             CUDA_GRAPH_INSTANTIATE_PARAMS*) {
  return instantiate("cuGraphInstantiateWithParams", exec);
}
EXPORT CUresult cuGraphInstantiateWithParams_ptsz(
    CUgraphExec* exec, CUgraph, CUDA_GRAPH_INSTANTIATE_PARAMS*) {
  return instantiate("cuGraphInstantiateWithParams_ptsz", exec);
}
EXPORT CUresult cuGraphExecDestroy(CUgraphExec) {
  called("cuGraphExecDestroy");
  return CUDA_SUCCESS;
}

EXPORT CUresult cuMemGetInfo_v2(size_t* free, size_t* total) {
  called("cuMemGetInfo_v2");
  std::lock_guard<std::mutex> lk(g_mu);
  *total = dev_mem();
  *free = dev_mem() - used_on(t_dev);
  return CUDA_SUCCESS;
}

EXPORT CUresult cuDeviceTotalMem_v2(size_t* bytes, CUdevice dev) {
  called("cuDeviceTotalMem_v2");
  if (dev < 0 || dev >= ndev()) return CUDA_ERROR_INVALID_VALUE;
  *bytes = dev_mem();
  return CUDA_SUCCESS;
}

#define LAUNCH_PARAMS                                                    \
  CUfunction, unsigned int, unsigned int, unsigned int, unsigned int,    \
      unsigned int, unsigned int, unsigned int, CUstream
EXPORT CUresult cuLaunchKernel(LAUNCH_PARAMS s, void**, void**) {
  return do_launch("cuLaunchKernel", s, false);
}
EXPORT CUresult cuLaunchKernel_ptsz(LAUNCH_PARAMS s, void**, void**) {
  return do_launch("cuLaunchKernel_ptsz", s, true);
}
EXPORT CUresult cuLaunchCooperativeKernel(LAUNCH_PARAMS s, void**) {
  return do_launch("cuLaunchCooperativeKernel", s, false);
}
EXPORT CUresult cuLaunchCooperativeKernel_ptsz(LAUNCH_PARAMS s, void**) {
  return do_launch("cuLaunchCooperativeKernel_ptsz", s, true);
}
EXPORT CUresult cuLaunchKernelEx(const CUlaunchConfig* c, CUfunction, void**,
                                 void**) {
  return do_launch("cuLaunchKernelEx", c ? c->hStream : nullptr, false);
}
EXPORT CUresult cuLaunchKernelEx_ptsz(const CUlaunchConfig* c, CUfunction,
                                      void**, void**) {
  return do_launch("cuLaunchKernelEx_ptsz", c ? c->hStream : nullptr, true);
}
EXPORT CUresult cuGraphLaunch(CUgraphExec, CUstream s) {
  return do_launch("cuGraphLaunch", s, false);
}
EXPORT CUresult cuGraphLaunch_ptsz(CUgraphExec, CUstream s) {
  return do_launch("cuGraphLaunch_ptsz", s, true);
}

/* ---- cuGetProcAddress --------------------------------------------------- */

/* Each base name: from `since` on it resolves to `name` (else to the
 * previous row of the same base), and to `ptsz` under the per-thread
 * default stream flag where the driver has such a variant. */
struct Proc {
  const char* base;
  int since;
  const char* name;
  void* fn;
  const char* ptsz_name;
  void* ptsz;
};
EXPORT CUresult cuGetProcAddress(const char*, void**, int, cuuint64_t);
EXPORT CUresult cuGetProcAddress_v2(const char*, void**, int, cuuint64_t,
                                    CUdriverProcAddressQueryResult*);
#define P(base, since, fn) {#base, since, #fn, (void*)&fn, nullptr, nullptr}
#define PZ(base, since, fn) \
  {#base, since, #fn, (void*)&fn, #fn "_ptsz", (void*)&fn##_ptsz}
static const Proc kProcs[] = {
    P(cuInit, 2000, cuInit),
    P(cuDeviceGetCount, 2000, cuDeviceGetCount),
    P(cuCtxGetDevice, 2000, cuCtxGetDevice),
    P(cuCtxGetCurrent, 4000, cuCtxGetCurrent),
    P(cuCtxSetCurrent, 4000, cuCtxSetCurrent),
    P(cuStreamQuery, 2000, cuStreamQuery),
    P(cuEventCreate, 2000, cuEventCreate),
    P(cuEventRecord, 2000, cuEventRecord),
    P(cuEventQuery, 2000, cuEventQuery),
    P(cuEventDestroy, 4000, cuEventDestroy_v2),
    P(cuCtxSynchronize, 2000, cuCtxSynchronize),
    P(cuGetProcAddress, 11030, cuGetProcAddress),
    P(cuGetProcAddress, 12000, cuGetProcAddress_v2),
    P(cuMemAlloc, 2000, cuMemAlloc),
    P(cuMemAlloc, 3020, cuMemAlloc_v2),
    P(cuMemAllocPitch, 3020, cuMemAllocPitch_v2),
    P(cuMemAllocManaged, 6000, cuMemAllocManaged),
    PZ(cuMemAllocAsync, 11020, cuMemAllocAsync),
    PZ(cuMemAllocFromPoolAsync, 11020, cuMemAllocFromPoolAsync),
    P(cuMemCreate, 10020, cuMemCreate),
    P(cuMemFree, 3020, cuMemFree_v2),
    PZ(cuMemFreeAsync, 11020, cuMemFreeAsync),
    P(cuMemRelease, 10020, cuMemRelease),
    P(cuArrayCreate, 3020, cuArrayCreate_v2),
    P(cuArray3DCreate, 3020, cuArray3DCreate_v2),
    P(cuMipmappedArrayCreate, 5000, cuMipmappedArrayCreate),
    P(cuArrayDestroy, 2000, cuArrayDestroy),
    P(cuMipmappedArrayDestroy, 5000, cuMipmappedArrayDestroy),
    P(cuGraphAddMemAllocNode, 11040, cuGraphAddMemAllocNode),
    P(cuGraphAddMemFreeNode, 11040, cuGraphAddMemFreeNode),
    P(cuGraphAddNode, 12020, cuGraphAddNode),
    P(cuGraphAddNode, 12030, cuGraphAddNode_v2),
    P(cuGraphInstantiate, 10000, cuGraphInstantiate),
    P(cuGraphInstantiate, 11000, cuGraphInstantiate_v2),
    P(cuGraphInstantiate, 12000, cuGraphInstantiateWithFlags),
    P(cuGraphInstantiateWithFlags, 11040, cuGraphInstantiateWithFlags),
    PZ(cuGraphInstantiateWithParams, 12000, cuGraphInstantiateWithParams),
    P(cuGraphExecDestroy, 10000, cuGraphExecDestroy),
    P(cuGraphDestroy, 10000, cuGraphDestroy),
    P(cuMemGetInfo, 3020, cuMemGetInfo_v2),
    P(cuDeviceTotalMem, 3020, cuDeviceTotalMem_v2),
    PZ(cuLaunchKernel, 4000, cuLaunchKernel),
    PZ(cuLaunchKernelEx, 11060, cuLaunchKernelEx),
    PZ(cuLaunchCooperativeKernel, 9000, cuLaunchCooperativeKernel),
    PZ(cuGraphLaunch, 10000, cuGraphLaunch),
};

EXPORT CUresult cuGetProcAddress_v2(const char* symbol, void** pfn,
                                    int cudaVersion, cuuint64_t flags,
                                    CUdriverProcAddressQueryResult* status) {
  called("cuGetProcAddress_v2");
  const Proc* best = nullptr;
  bool known = false;
  for (const Proc& p : kProcs) {
    if (strcmp(p.base, symbol) != 0) continue;
    known = true;
    if (p.since <= cudaVersion && (!best || p.since > best->since)) best = &p;
  }
  if (!best) {
    *pfn = nullptr;
    if (status)
      *status = known ? CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT
                      : CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND;
    return CUDA_ERROR_NOT_FOUND;
  }
  bool per_thread = flags & CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM;
  *pfn = per_thread && best->ptsz ? best->ptsz : best->fn;
  if (status) *status = CU_GET_PROC_ADDRESS_SUCCESS;
  return CUDA_SUCCESS;
}

EXPORT CUresult cuGetProcAddress(const char* symbol, void** pfn,
                                 int cudaVersion, cuuint64_t flags) {
  return cuGetProcAddress_v2(symbol, pfn, cudaVersion, flags, nullptr);
}

/* ---- mock-only helpers -------------------------------------------------- */

EXPORT void* mockRealAddress(const char* name) {
  for (const Proc& p : kProcs) {
    if (strcmp(p.name, name) == 0) return p.fn;
    if (p.ptsz_name && strcmp(p.ptsz_name, name) == 0) return p.ptsz;
  }
  return nullptr;
}

EXPORT uint64_t mockCalls(const char* name) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_calls.find(name);
  return it == g_calls.end() ? 0 : it->second;
}

EXPORT int mockIsManaged(CUdeviceptr p) {
  std::lock_guard<std::mutex> lk(g_mu);
  auto it = g_allocs.find(p);
  return it != g_allocs.end() && it->second.managed;
}

EXPORT uint64_t mockUsedBytes(int dev) {
  std::lock_guard<std::mutex> lk(g_mu);
  return used_on(dev);
}

#endif /* MOCK_LIB_CUDA */

#ifdef MOCK_LIB_NVML

/* The CUDA mock's timeline and ledger, looked up in libcuda.so.1. */
template <class F>
static F* cuda_mock(const char* name) {
  void* h = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
  F* f = h ? (F*)dlsym(h, name) : nullptr;
  if (h) dlclose(h);
  return f;
}

static unsigned int ndev() {
  return (unsigned int)std::min<uint64_t>(env_u64("MOCK_CUDA_DEVICES", 1),
                                          16);
}

EXPORT nvmlReturn_t nvmlInit_v2(void) { return NVML_SUCCESS; }
EXPORT nvmlReturn_t nvmlShutdown(void) { return NVML_SUCCESS; }

EXPORT nvmlReturn_t nvmlDeviceGetHandleByIndex_v2(unsigned int index,
                                                  nvmlDevice_t* device) {
  if (index >= ndev()) return NVML_ERROR_INVALID_ARGUMENT;
  *device = (nvmlDevice_t)(uintptr_t)(index + 1);
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetIndex(nvmlDevice_t device,
                                       unsigned int* index) {
  unsigned int i = (unsigned int)(uintptr_t)device - 1;
  if (i >= ndev()) return NVML_ERROR_INVALID_ARGUMENT;
  *index = i;
  return NVML_SUCCESS;
}

static nvmlReturn_t memory(nvmlDevice_t device, unsigned long long* total,
                           unsigned long long* free,
                           unsigned long long* used) {
  unsigned int i = 0;
  if ((uintptr_t)device >= 0x1000 && getenv("MOCK_NVML_MIG")) {
    *total = 9856ull << 20;  /* a MIG instance's own memory */
    *used = 0;
    *free = *total;
    return NVML_SUCCESS;
  }
  if (nvmlDeviceGetIndex(device, &i) != NVML_SUCCESS)
    return NVML_ERROR_INVALID_ARGUMENT;
  auto* used_of = cuda_mock<uint64_t(int)>("mockUsedBytes");
  *total = env_u64("MOCK_CUDA_MEM", 80ull << 30);
  *used = used_of ? used_of((int)i) : 0;
  *free = *total - *used;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetMemoryInfo(nvmlDevice_t device,
                                            nvmlMemory_t* m) {
  return memory(device, &m->total, &m->free, &m->used);
}

EXPORT nvmlReturn_t nvmlDeviceGetMemoryInfo_v2(nvmlDevice_t device,
                                               nvmlMemory_v2_t* m) {
  m->reserved = 0;
  return memory(device, &m->total, &m->free, &m->used);
}

/* The whole card's utilisation, as the driver would report it: a fixed
 * reading (MOCK_NVML_UTIL_GPU, default 77; memory 55) that a view under
 * the interposer must never pass on. */
EXPORT nvmlReturn_t nvmlDeviceGetUtilizationRates(nvmlDevice_t device,
                                                  nvmlUtilization_t* u) {
  unsigned int i = 0;
  if (nvmlDeviceGetIndex(device, &i) != NVML_SUCCESS)
    return NVML_ERROR_INVALID_ARGUMENT;
  u->gpu = (unsigned int)env_u64("MOCK_NVML_UTIL_GPU", 77);
  u->memory = 55;
  return NVML_SUCCESS;
}

/* ---- discovery -------------------------------------------------------- */

/* Layouts of nvml.h (CUDA 12). */
struct nvmlPciInfo_t {
  char busIdLegacy[16];
  unsigned int domain, bus, device, pciDeviceId, pciSubSystemId;
  char busId[32];
};
struct nvmlDeviceAttributes_t {
  unsigned int multiprocessorCount, sharedCopyEngineCount,
      sharedDecoderCount, sharedEncoderCount, sharedJpegCount,
      sharedOfaCount, gpuInstanceSliceCount, computeInstanceSliceCount;
  unsigned long long memorySizeMB;
};
struct nvmlEventData_t {
  nvmlDevice_t device;
  unsigned long long eventType, eventData;
  unsigned int gpuInstanceId, computeInstanceId;
};
typedef struct MockEventSet* nvmlEventSet_t;
enum {
  NVML_ERROR_TIMEOUT = 10,
  NVML_P2P_CAPS_INDEX_NVLINK = 2,
  NVML_P2P_STATUS_NOT_SUPPORTED = 5,
  NVML_TOPOLOGY_INTERNAL = 0,
  NVML_TOPOLOGY_NODE = 40,
  NVML_TOPOLOGY_SYSTEM = 50,
  kMigPerCard = 7,
  kMigBase = 0x1000,
};
static const unsigned long long kXidCritical = 0x8;

static bool mig_on() { return env_u64("MOCK_NVML_MIG", 0) != 0; }

/* A MIG instance's handle: kMigBase + 16 * card + instance. */
static bool mig_of(nvmlDevice_t device, unsigned int* card,
                   unsigned int* inst) {
  uintptr_t h = (uintptr_t)device;
  if (h < kMigBase) return false;
  *card = (unsigned int)((h - kMigBase) / 16);
  *inst = (unsigned int)((h - kMigBase) % 16);
  return *card < ndev() && *inst < kMigPerCard;
}

static bool card_of(nvmlDevice_t device, unsigned int* card) {
  unsigned int inst = 0;
  if (mig_of(device, card, &inst)) return false;
  return nvmlDeviceGetIndex(device, card) == NVML_SUCCESS;
}

static nvmlReturn_t put(char* buf, unsigned int len, const std::string& v) {
  if (buf == nullptr || v.size() + 1 > len) return NVML_ERROR_INSUFFICIENT_SIZE;
  memcpy(buf, v.c_str(), v.size() + 1);
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetCount_v2(unsigned int* count) {
  *count = ndev();
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetUUID(nvmlDevice_t device, char* uuid,
                                      unsigned int length) {
  unsigned int c = 0, j = 0;
  char v[64];
  if (mig_of(device, &c, &j))
    snprintf(v, sizeof(v), "MIG-mock-%02u-%u", c, j);
  else if (card_of(device, &c))
    snprintf(v, sizeof(v), "GPU-mock-%02u", c);
  else
    return NVML_ERROR_INVALID_ARGUMENT;
  return put(uuid, length, v);
}

EXPORT nvmlReturn_t nvmlDeviceGetName(nvmlDevice_t device, char* name,
                                      unsigned int length) {
  unsigned int c = 0, j = 0;
  if (mig_of(device, &c, &j))
    return put(name, length, "NVIDIA H100 80GB HBM3 MIG 1g.10gb");
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  return put(name, length, "NVIDIA H100 80GB HBM3");
}

EXPORT nvmlReturn_t nvmlDeviceGetPciInfo_v3(nvmlDevice_t device,
                                            nvmlPciInfo_t* pci) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  memset(pci, 0, sizeof(*pci));
  pci->bus = 0x18 + c;
  pci->pciDeviceId = 0x233010de;
  snprintf(pci->busId, sizeof(pci->busId), "00000000:%02X:00.0", pci->bus);
  snprintf(pci->busIdLegacy, sizeof(pci->busIdLegacy), "0000:%02X:00.0",
           pci->bus);
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetMinorNumber(nvmlDevice_t device,
                                             unsigned int* minor) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  *minor = c;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetNumaNodeId(nvmlDevice_t device,
                                            unsigned int* node) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  *node = c < ndev() / 2 || ndev() < 2 ? 0 : 1;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetMigMode(nvmlDevice_t device,
                                         unsigned int* current,
                                         unsigned int* pending) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  *current = *pending = mig_on() ? 1 : 0;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetMaxMigDeviceCount(nvmlDevice_t device,
                                                   unsigned int* count) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  *count = mig_on() ? kMigPerCard : 0;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetMigDeviceHandleByIndex(
    nvmlDevice_t device, unsigned int index, nvmlDevice_t* mig) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  if (!mig_on() || index >= kMigPerCard) return NVML_ERROR_NOT_FOUND;
  *mig = (nvmlDevice_t)(uintptr_t)(kMigBase + 16 * c + index);
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetAttributes_v2(nvmlDevice_t device,
                                               nvmlDeviceAttributes_t* a) {
  unsigned int c = 0, j = 0;
  if (!mig_of(device, &c, &j)) return NVML_ERROR_NOT_SUPPORTED;
  memset(a, 0, sizeof(*a));
  a->multiprocessorCount = 16;
  a->gpuInstanceSliceCount = a->computeInstanceSliceCount = 1;
  a->memorySizeMB = 9856;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetP2PStatus(nvmlDevice_t d1, nvmlDevice_t d2,
                                           int caps, int* status) {
  unsigned int a = 0, b = 0;
  if (!card_of(d1, &a) || !card_of(d2, &b)) return NVML_ERROR_INVALID_ARGUMENT;
  if (caps != NVML_P2P_CAPS_INDEX_NVLINK) return NVML_ERROR_NOT_SUPPORTED;
  const char* links = getenv("MOCK_NVML_LINKS");
  bool pairs = links && strcmp(links, "pairs") == 0;
  *status = a != b && (!pairs || a / 2 == b / 2)
                ? 0
                : NVML_P2P_STATUS_NOT_SUPPORTED;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetTopologyCommonAncestor(nvmlDevice_t d1,
                                                        nvmlDevice_t d2,
                                                        int* level) {
  unsigned int a = 0, b = 0;
  if (!card_of(d1, &a) || !card_of(d2, &b)) return NVML_ERROR_INVALID_ARGUMENT;
  unsigned int half = ndev() / 2 ? ndev() / 2 : 1;
  *level = a == b ? NVML_TOPOLOGY_INTERNAL
           : a / half == b / half ? NVML_TOPOLOGY_NODE
                                  : NVML_TOPOLOGY_SYSTEM;
  return NVML_SUCCESS;
}

/* ---- events ------------------------------------------------------------ */

struct MockEventSet {
  unsigned long long types[16];
  size_t delivered;  /* lines of MOCK_NVML_XID_FILE already delivered */
};

EXPORT nvmlReturn_t nvmlEventSetCreate(nvmlEventSet_t* set) {
  *set = new MockEventSet();
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlEventSetFree(nvmlEventSet_t set) {
  delete set;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceGetSupportedEventTypes(
    nvmlDevice_t device, unsigned long long* types) {
  unsigned int c = 0;
  if (!card_of(device, &c)) return NVML_ERROR_INVALID_ARGUMENT;
  *types = 0xff9f;
  return NVML_SUCCESS;
}

EXPORT nvmlReturn_t nvmlDeviceRegisterEvents(nvmlDevice_t device,
                                             unsigned long long types,
                                             nvmlEventSet_t set) {
  unsigned int c = 0;
  if (!card_of(device, &c) || set == nullptr)
    return NVML_ERROR_INVALID_ARGUMENT;
  set->types[c] |= types;
  return NVML_SUCCESS;
}

/* The next scripted event of a registered card, if any (the timeout is
 * not waited: the script is read as it stands). */
EXPORT nvmlReturn_t nvmlEventSetWait_v2(nvmlEventSet_t set,
                                        nvmlEventData_t* data,
                                        unsigned int) {
  const char* path = getenv("MOCK_NVML_XID_FILE");
  FILE* f = path ? fopen(path, "r") : nullptr;
  if (f == nullptr) return (nvmlReturn_t)NVML_ERROR_TIMEOUT;
  unsigned int card = 0;
  unsigned long long xid = 0;
  size_t line = 0;
  nvmlReturn_t r = (nvmlReturn_t)NVML_ERROR_TIMEOUT;
  while (fscanf(f, "%u %llu", &card, &xid) == 2) {
    if (line++ < set->delivered) continue;
    set->delivered = line;
    if (card >= ndev() || !(set->types[card] & kXidCritical)) continue;
    memset(data, 0, sizeof(*data));
    data->device = (nvmlDevice_t)(uintptr_t)(card + 1);
    data->eventType = kXidCritical;
    data->eventData = xid;
    r = NVML_SUCCESS;
    break;
  }
  fclose(f);
  return r;
}

#endif /* MOCK_LIB_NVML */
