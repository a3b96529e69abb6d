/* abi_check.cc — holds cuda_abi.h against the CUDA toolkit's own cuda.h
 * and nvml.h.  It is compiled, never run: a drifted type, field or
 * signature fails the compile.
 *
 *   g++ -std=c++17 -fsyntax-only -I/usr/local/cuda/include abi_check.cc
 *
 * (ops/_build.abi_check(); chip_smoke.py phase 1 runs it on the card's
 * machine, where the toolkit is installed.)
 */
#include <stddef.h>

#include <type_traits>

#include <cuda.h>
#include <nvml.h>

#include "cuda_abi.h"

namespace a = vtpu_abi;

/* M<T>: the toolkit's type for one of cuda_abi.h's, built up through
 * pointers, const and function types; scalars map to themselves. */
template <class T>
struct M {
  using type = T;
};
template <class T>
using M_t = typename M<T>::type;
template <class T>
struct M<T*> {
  using type = M_t<T>*;
};
template <class T>
struct M<const T> {
  using type = const M_t<T>;
};
template <class R, class... A>
struct M<R(A...)> {
  using type = M_t<R>(M_t<A>...);
};
#define MAP(ours, theirs) \
  template <>             \
  struct M<ours> {        \
    using type = theirs;  \
  };
MAP(a::CUresult, ::CUresult)
MAP(a::CUdriverProcAddressQueryResult, ::CUdriverProcAddressQueryResult)
MAP(a::CUctx_st, ::CUctx_st)
MAP(a::CUfunc_st, ::CUfunc_st)
MAP(a::CUstream_st, ::CUstream_st)
MAP(a::CUgraphExec_st, ::CUgraphExec_st)
MAP(a::CUgraph_st, ::CUgraph_st)
MAP(a::CUgraphNode_st, ::CUgraphNode_st)
MAP(a::CUevent_st, ::CUevent_st)
MAP(a::CUarray_st, ::CUarray_st)
MAP(a::CUmipmappedArray_st, ::CUmipmappedArray_st)
MAP(a::CUDA_ARRAY_DESCRIPTOR, ::CUDA_ARRAY_DESCRIPTOR)
MAP(a::CUDA_ARRAY3D_DESCRIPTOR, ::CUDA_ARRAY3D_DESCRIPTOR)
MAP(a::CUDA_MEM_ALLOC_NODE_PARAMS, ::CUDA_MEM_ALLOC_NODE_PARAMS)
MAP(a::CUgraphNodeParams, ::CUgraphNodeParams)
MAP(a::CUgraphEdgeData, ::CUgraphEdgeData)
MAP(a::CUDA_GRAPH_INSTANTIATE_PARAMS, ::CUDA_GRAPH_INSTANTIATE_PARAMS)
MAP(a::CUmemPoolHandle_st, ::CUmemPoolHandle_st)
MAP(a::CUlaunchConfig, ::CUlaunchConfig)
MAP(a::CUmemAllocationProp, ::CUmemAllocationProp)
MAP(a::nvmlReturn_t, ::nvmlReturn_t)
MAP(a::nvmlDevice_st, ::nvmlDevice_st)
MAP(a::nvmlMemory_t, ::nvmlMemory_t)
MAP(a::nvmlMemory_v2_t, ::nvmlMemory_v2_t)

/* Scalar typedefs: the same type, not just the same size. */
static_assert(std::is_same<a::cuuint64_t, ::cuuint64_t>::value, "cuuint64_t");
static_assert(std::is_same<a::CUdevice, ::CUdevice>::value, "CUdevice");
static_assert(std::is_same<a::CUdeviceptr, ::CUdeviceptr>::value,
              "CUdeviceptr");
static_assert(std::is_same<a::CUmemGenericAllocationHandle,
                           ::CUmemGenericAllocationHandle>::value,
              "CUmemGenericAllocationHandle");
static_assert(std::is_same<M_t<a::CUcontext>, ::CUcontext>::value,
              "CUcontext");
static_assert(sizeof(a::CUresult) == sizeof(::CUresult), "CUresult size");
static_assert(sizeof(a::nvmlReturn_t) == sizeof(::nvmlReturn_t),
              "nvmlReturn_t size");

/* The enumerators the interposer and the mock use. */
#define VALUE(name) \
  static_assert((long long)a::name == (long long)::name, #name);
VALUE(CUDA_SUCCESS)
VALUE(CUDA_ERROR_INVALID_VALUE)
VALUE(CUDA_ERROR_OUT_OF_MEMORY)
VALUE(CUDA_ERROR_NOT_INITIALIZED)
VALUE(CUDA_ERROR_INVALID_CONTEXT)
VALUE(CUDA_ERROR_NOT_FOUND)
VALUE(CUDA_ERROR_NOT_READY)
VALUE(CUDA_ERROR_NOT_PERMITTED)
VALUE(CUDA_ERROR_NOT_SUPPORTED)
VALUE(CU_GET_PROC_ADDRESS_SUCCESS)
VALUE(CU_GET_PROC_ADDRESS_SYMBOL_NOT_FOUND)
VALUE(CU_GET_PROC_ADDRESS_VERSION_NOT_SUFFICIENT)
VALUE(CU_GET_PROC_ADDRESS_DEFAULT)
VALUE(CU_GET_PROC_ADDRESS_LEGACY_STREAM)
VALUE(CU_GET_PROC_ADDRESS_PER_THREAD_DEFAULT_STREAM)
VALUE(CU_MEM_ATTACH_GLOBAL)
VALUE(CU_EVENT_DISABLE_TIMING)
VALUE(CU_AD_FORMAT_UNSIGNED_INT8)
VALUE(CU_AD_FORMAT_UNSIGNED_INT16)
VALUE(CU_AD_FORMAT_UNSIGNED_INT32)
VALUE(CU_AD_FORMAT_SIGNED_INT8)
VALUE(CU_AD_FORMAT_SIGNED_INT16)
VALUE(CU_AD_FORMAT_SIGNED_INT32)
VALUE(CU_AD_FORMAT_HALF)
VALUE(CU_AD_FORMAT_FLOAT)
VALUE(CU_MEM_ALLOCATION_TYPE_PINNED)
VALUE(CU_GRAPH_NODE_TYPE_MEM_ALLOC)
VALUE(CU_GRAPH_NODE_TYPE_MEM_FREE)
VALUE(CU_MEM_LOCATION_TYPE_DEVICE)
VALUE(NVML_SUCCESS)
VALUE(NVML_ERROR_UNINITIALIZED)
VALUE(NVML_ERROR_INVALID_ARGUMENT)
VALUE(NVML_ERROR_NOT_SUPPORTED)
VALUE(NVML_ERROR_NOT_FOUND)
VALUE(NVML_ERROR_INSUFFICIENT_SIZE)

/* cuda.h's macros that cuda_abi.h gives names of its own. */
static_assert(a::kArray3DLayered == CUDA_ARRAY3D_LAYERED, "LAYERED");
static_assert(a::kArray3DCubemap == CUDA_ARRAY3D_CUBEMAP, "CUBEMAP");

/* Every struct the interposer reads or writes: size, and each field's
 * offset and size. */
#define STRUCT(S) static_assert(sizeof(a::S) == sizeof(::S), #S " size");
#define FIELD(S, f)                                                  \
  static_assert(offsetof(a::S, f) == offsetof(::S, f) &&             \
                    sizeof(((a::S*)0)->f) == sizeof(((::S*)0)->f),   \
                #S "." #f);
STRUCT(CUlaunchConfig)
FIELD(CUlaunchConfig, gridDimX)
FIELD(CUlaunchConfig, gridDimY)
FIELD(CUlaunchConfig, gridDimZ)
FIELD(CUlaunchConfig, blockDimX)
FIELD(CUlaunchConfig, blockDimY)
FIELD(CUlaunchConfig, blockDimZ)
FIELD(CUlaunchConfig, sharedMemBytes)
FIELD(CUlaunchConfig, hStream)
FIELD(CUlaunchConfig, attrs)
FIELD(CUlaunchConfig, numAttrs)
STRUCT(CUmemAllocationProp)
FIELD(CUmemAllocationProp, type)
FIELD(CUmemAllocationProp, requestedHandleTypes)
FIELD(CUmemAllocationProp, location)
FIELD(CUmemAllocationProp, location.type)
FIELD(CUmemAllocationProp, location.id)
FIELD(CUmemAllocationProp, win32HandleMetaData)
FIELD(CUmemAllocationProp, allocFlags)
STRUCT(CUDA_ARRAY_DESCRIPTOR)
FIELD(CUDA_ARRAY_DESCRIPTOR, Width)
FIELD(CUDA_ARRAY_DESCRIPTOR, Height)
FIELD(CUDA_ARRAY_DESCRIPTOR, Format)
FIELD(CUDA_ARRAY_DESCRIPTOR, NumChannels)
STRUCT(CUDA_ARRAY3D_DESCRIPTOR)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, Width)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, Height)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, Depth)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, Format)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, NumChannels)
FIELD(CUDA_ARRAY3D_DESCRIPTOR, Flags)
STRUCT(CUmemPoolProps)
FIELD(CUmemPoolProps, allocType)
FIELD(CUmemPoolProps, handleTypes)
FIELD(CUmemPoolProps, location)
FIELD(CUmemPoolProps, location.type)
FIELD(CUmemPoolProps, location.id)
FIELD(CUmemPoolProps, win32SecurityAttributes)
STRUCT(CUDA_MEM_ALLOC_NODE_PARAMS)
FIELD(CUDA_MEM_ALLOC_NODE_PARAMS, poolProps)
FIELD(CUDA_MEM_ALLOC_NODE_PARAMS, accessDescs)
FIELD(CUDA_MEM_ALLOC_NODE_PARAMS, accessDescCount)
FIELD(CUDA_MEM_ALLOC_NODE_PARAMS, bytesize)
FIELD(CUDA_MEM_ALLOC_NODE_PARAMS, dptr)
STRUCT(CUDA_MEM_FREE_NODE_PARAMS)
FIELD(CUDA_MEM_FREE_NODE_PARAMS, dptr)
STRUCT(CUgraphNodeParams)
FIELD(CUgraphNodeParams, type)
FIELD(CUgraphNodeParams, alloc)
FIELD(CUgraphNodeParams, free)
/* cuGraphAddNode's `alloc` is the _v2 struct: the same fields at the same
 * offsets as the one cuGraphAddMemAllocNode takes. */
#define ALLOC_V2(f)                                                      \
  static_assert(offsetof(::CUDA_MEM_ALLOC_NODE_PARAMS_v2, f) ==          \
                    offsetof(a::CUDA_MEM_ALLOC_NODE_PARAMS, f),          \
                "CUDA_MEM_ALLOC_NODE_PARAMS_v2." #f);
ALLOC_V2(poolProps)
ALLOC_V2(poolProps.location)
ALLOC_V2(bytesize)
ALLOC_V2(dptr)
static_assert(sizeof(::CUDA_MEM_ALLOC_NODE_PARAMS_v2) ==
                  sizeof(a::CUDA_MEM_ALLOC_NODE_PARAMS),
              "CUDA_MEM_ALLOC_NODE_PARAMS_v2 size");
STRUCT(nvmlMemory_t)
FIELD(nvmlMemory_t, total)
FIELD(nvmlMemory_t, free)
FIELD(nvmlMemory_t, used)
STRUCT(nvmlMemory_v2_t)
FIELD(nvmlMemory_v2_t, version)
FIELD(nvmlMemory_v2_t, total)
FIELD(nvmlMemory_v2_t, reserved)
FIELD(nvmlMemory_v2_t, free)
FIELD(nvmlMemory_v2_t, used)

/* Every hooked or called function's type, exactly. */
#define SIG(name)                                                     \
  static_assert(std::is_same<M_t<a::fn_##name>, decltype(::name)>::value, \
                #name " signature");
SIG(cuInit)
SIG(cuDeviceGetCount)
SIG(cuCtxGetDevice)
SIG(cuCtxGetCurrent)
SIG(cuCtxSetCurrent)
SIG(cuStreamQuery)
SIG(cuEventCreate)
SIG(cuEventRecord)
SIG(cuEventQuery)
SIG(cuEventDestroy_v2)
SIG(cuGetProcAddress_v2)
SIG(cuMemAlloc_v2)
SIG(cuMemAllocPitch_v2)
SIG(cuMemAllocManaged)
SIG(cuMemAllocAsync)
SIG(cuMemAllocFromPoolAsync)
SIG(cuMemCreate)
SIG(cuMemFree_v2)
SIG(cuMemFreeAsync)
SIG(cuMemRelease)
SIG(cuArrayCreate_v2)
SIG(cuArray3DCreate_v2)
SIG(cuMipmappedArrayCreate)
SIG(cuArrayDestroy)
SIG(cuMipmappedArrayDestroy)
SIG(cuGraphAddMemAllocNode)
SIG(cuGraphAddMemFreeNode)
SIG(cuGraphAddNode)
SIG(cuGraphAddNode_v2)
SIG(cuGraphDestroy)
SIG(cuGraphInstantiateWithFlags)
SIG(cuGraphInstantiateWithParams)
SIG(cuGraphExecDestroy)
SIG(cuMemGetInfo_v2)
SIG(cuDeviceTotalMem_v2)
SIG(cuLaunchKernel)
SIG(cuLaunchKernelEx)
SIG(cuLaunchCooperativeKernel)
SIG(cuGraphLaunch)
SIG(nvmlInit_v2)
SIG(nvmlDeviceGetHandleByIndex_v2)
SIG(nvmlDeviceGetIndex)
SIG(nvmlDeviceGetMemoryInfo)
SIG(nvmlDeviceGetMemoryInfo_v2)

/* cuGetProcAddress of CUDA 11.x takes no status argument; the 12 header
 * declares only the _v2 form, so its own arguments are held here. */
static_assert(std::is_same<M_t<a::fn_cuGetProcAddress>,
                           ::CUresult(const char*, void**, int,
                                      ::cuuint64_t)>::value,
              "cuGetProcAddress (11.x) signature");

/* cuGraphInstantiate[_v2] of CUDA 10-11, which the 12 header does not
 * declare under those names either. */
static_assert(std::is_same<M_t<a::fn_cuGraphInstantiate_v2>,
                           ::CUresult(::CUgraphExec*, ::CUgraph,
                                      ::CUgraphNode*, char*, size_t)>::value,
              "cuGraphInstantiate_v2 (10-11) signature");
