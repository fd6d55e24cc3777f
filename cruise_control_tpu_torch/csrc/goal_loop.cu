// KL: the goal loops' control on the device. One thread updates a goal
// pass's loop counters and writes the next loop test into a CUDA graph
// conditional handle, so a whole goal pass (its converged test, the bulk
// drain's rounds, the fine loop and the apply rounds inside it) runs as one
// graph whose loops the card runs without a host read per iteration.
//
// Replaces the control of the reference's per-goal device program
// (cruise_control_tpu/analyzer/engine.py:make_goal_pass, :130-291: the
// lax.cond on the converged test, the drain while_loop, the fine
// while_loop and the apply-rounds while_loop inside it; _fused_impl,
// :369-386, runs the passes back to back). The loop bodies are the port's
// own segments (analyzer/engine.py), captured with torch.cuda.CUDAGraph and
// placed as child graphs into the conditional nodes built here
// (analyzer/graph_loop.py).
//
// The counters of one pass are an int64 vector (Slot). A body segment
// writes its test's reading into kFlag (the drain round's applied count,
// "candidates still pending and some applied", the converged test), and
// the fine loop's apply rounds add their applied moves into kApplied; KL
// does the rest. Each op mirrors one step of the host loop
// (analyzer/engine.py:HostLoop), and counts the body executions so that
// the host can credit the kernels replayed inside the bodies.
//
// Bound on the card: one dependent load and store of a few words — a
// launch's floor. Design: one thread, no shared memory; the condition is
// also stored in kCond so that an eager launch (no handle) can be held to
// the plain twin (kernels.goal_loop_step_plain).
//
// The graph functions use the runtime API on graphs made by another
// runtime (PyTorch's): a cudaGraph_t is a CUgraph, handed across
// as a raw pointer. Conditional nodes need CUDA 12.3; nested ones (the
// rounds inside the fine loop inside the converged test) 12.4.

#include <cstdint>
#include <cstdio>
#include <cuda_runtime.h>

namespace {

// (kernels.py:GOAL_LOOP_SLOTS)
enum Slot : int {
  kFlag = 0, kIt, kStalls, kRound, kRounds, kApplied,
  kExecActive, kExecDrain, kExecFine, kExecRound, kExecLoop, kCond, kSlots
};

// (kernels.py:GOAL_LOOP_OPS)
enum Op : int {
  kActive = 0,      // cond = flag; zero the loop counters
  kDrainEnter = 1,  // round = 0; cond = rounds_max > 0
  kDrainStep = 2,   // round += 1; cond = round < a && flag >= b
  kFineEnter = 3,   // it = stalls = 0; cond = a > 0 && b > 0
  kRoundsEnter = 4, // rounds = applied = 0; cond = flag && a > 0
  kRoundsStep = 5,  // rounds += 1; cond = rounds < a && flag
  kFineStep = 6,    // stalls = applied ? 0 : stalls + 1; it += 1;
                    // cond = stalls < a && it < b
};

__device__ __forceinline__ long long step(long long* c, int op, long long a,
                                          long long b) {
  long long cond = 0;
  switch (op) {
    case kActive:
      c[kIt] = 0; c[kStalls] = 0; c[kRound] = 0; c[kRounds] = 0;
      c[kApplied] = 0;
      cond = c[kFlag] != 0;
      c[kExecActive] += cond;
      break;
    case kDrainEnter:
      c[kRound] = 0;
      cond = a > 0;
      break;
    case kDrainStep:
      c[kExecDrain] += 1;
      c[kRound] += 1;
      cond = c[kRound] < a && c[kFlag] >= b;
      break;
    case kFineEnter:
      c[kIt] = 0; c[kStalls] = 0;
      cond = a > 0 && b > 0;
      break;
    case kRoundsEnter:
      c[kExecFine] += 1;
      c[kRounds] = 0; c[kApplied] = 0;
      cond = c[kFlag] != 0 && a > 0;
      break;
    case kRoundsStep:
      c[kExecRound] += 1;
      c[kRounds] += 1;
      cond = c[kRounds] < a && c[kFlag] != 0;
      break;
    case kFineStep:
      c[kStalls] = c[kApplied] == 0 ? c[kStalls] + 1 : 0;
      c[kIt] += 1;
      cond = c[kStalls] < a && c[kIt] < b;
      break;
    default:
      cond = 0;
  }
  c[kExecLoop] += 1;
  c[kCond] = cond;
  return cond;
}

__global__ void goal_loop_kernel(long long* c, int op, long long a,
                                 long long b,
                                 cudaGraphConditionalHandle handle,
                                 int has_handle) {
  const long long cond = step(c, op, a, b);
  if (has_handle) cudaGraphSetConditional(handle, cond ? 1u : 0u);
}

bool allowed_in_body(cudaGraph_t graph, char* msg, int len);

bool device_pointer(const void* ptr) {
  cudaPointerAttributes attr{};
  if (cudaPointerGetAttributes(&attr, ptr) != cudaSuccess) {
    cudaGetLastError();
    return false;
  }
  return attr.type == cudaMemoryTypeDevice ||
         attr.type == cudaMemoryTypeManaged;
}

const char* type_name(cudaGraphNodeType t) {
  switch (t) {
    case cudaGraphNodeTypeKernel: return "kernel";
    case cudaGraphNodeTypeMemcpy: return "memcpy";
    case cudaGraphNodeTypeMemset: return "memset";
    case cudaGraphNodeTypeHost: return "host";
    case cudaGraphNodeTypeGraph: return "child graph";
    case cudaGraphNodeTypeEmpty: return "empty";
    case cudaGraphNodeTypeWaitEvent: return "event wait";
    case cudaGraphNodeTypeEventRecord: return "event record";
    case cudaGraphNodeTypeExtSemaphoreSignal: return "semaphore signal";
    case cudaGraphNodeTypeExtSemaphoreWait: return "semaphore wait";
    case cudaGraphNodeTypeMemAlloc: return "memory allocation";
    case cudaGraphNodeTypeMemFree: return "memory free";
    case cudaGraphNodeTypeConditional: return "conditional";
    default: return "unknown";
  }
}

// A conditional body may hold kernels, device-to-device copies, memsets,
// empty nodes, child graphs and conditionals (the CUDA documentation of
// conditional graph nodes); anything else is named in msg.
bool allowed_in_body(cudaGraph_t graph, char* msg, int len) {
  size_t n = 0;
  if (cudaGraphGetNodes(graph, nullptr, &n) != cudaSuccess) {
    snprintf(msg, len, "cudaGraphGetNodes failed");
    return false;
  }
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n ? n : 1];
  bool ok = cudaGraphGetNodes(graph, nodes, &n) == cudaSuccess;
  for (size_t i = 0; ok && i < n; ++i) {
    cudaGraphNodeType t;
    if (cudaGraphNodeGetType(nodes[i], &t) != cudaSuccess) {
      snprintf(msg, len, "cudaGraphNodeGetType failed");
      ok = false;
      break;
    }
    switch (t) {
      case cudaGraphNodeTypeKernel:
      case cudaGraphNodeTypeMemset:
      case cudaGraphNodeTypeEmpty:
      case cudaGraphNodeTypeConditional:
        break;
      case cudaGraphNodeTypeMemcpy: {
        cudaMemcpy3DParms p{};
        if (cudaGraphMemcpyNodeGetParams(nodes[i], &p) != cudaSuccess ||
            p.srcArray || p.dstArray ||
            p.kind == cudaMemcpyHostToDevice ||
            p.kind == cudaMemcpyDeviceToHost ||
            p.kind == cudaMemcpyHostToHost ||
            !device_pointer(p.srcPtr.ptr) || !device_pointer(p.dstPtr.ptr)) {
          snprintf(msg, len, "a memcpy node that is not device to device");
          ok = false;
        }
        break;
      }
      case cudaGraphNodeTypeGraph: {
        cudaGraph_t child;
        ok = cudaGraphChildGraphNodeGetGraph(nodes[i], &child) ==
                 cudaSuccess && allowed_in_body(child, msg, len);
        break;
      }
      default:
        snprintf(msg, len, "a %s node", type_name(t));
        ok = false;
    }
  }
  delete[] nodes;
  return ok;
}

int add_node(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
             cudaGraphNodeParams* params) {
#if CUDART_VERSION >= 13000
  return static_cast<int>(cudaGraphAddNode(node, graph, dep ? &dep : nullptr,
                                           nullptr, dep ? 1 : 0, params));
#else
  return static_cast<int>(cudaGraphAddNode(node, graph, dep ? &dep : nullptr,
                                           dep ? 1 : 0, params));
#endif
}

}  // namespace

// One eager step of KL on `stream` (no graph, no handle): the counters are
// updated and the condition stored in slot kCond.
extern "C" int cc_goal_loop_step(void* ctr, int op, int64_t a, int64_t b,
                                 void* stream) {
  goal_loop_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(ctr), op, a, b, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int cc_graph_create(void** graph) {
  return static_cast<int>(
      cudaGraphCreate(reinterpret_cast<cudaGraph_t*>(graph), 0));
}

extern "C" int cc_graph_destroy(void* graph) {
  return static_cast<int>(cudaGraphDestroy(static_cast<cudaGraph_t>(graph)));
}

// 0 if `graph` may be a conditional body, else 1 with the offending node
// named in msg.
extern "C" int cc_graph_check_body(void* graph, char* msg, int len) {
  msg[0] = 0;
  return allowed_in_body(static_cast<cudaGraph_t>(graph), msg, len) ? 0 : 1;
}

// A child-graph node (a clone of `child`) after `dep` (or at the root).
extern "C" int cc_graph_add_child(void* graph, void* dep, void* child,
                                  void** node) {
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return static_cast<int>(cudaGraphAddChildGraphNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0,
      static_cast<cudaGraph_t>(child)));
}

// A KL kernel node after `dep`: op over the counters `ctr`, writing the
// condition into `handle` where has_handle.
extern "C" int cc_graph_add_loop(void* graph, void* dep, void* ctr, int op,
                                 int64_t a, int64_t b, uint64_t handle,
                                 int has_handle, void** node) {
  long long* c = static_cast<long long*>(ctr);
  long long la = a, lb = b;
  cudaGraphConditionalHandle h = handle;
  void* args[] = {&c, &op, &la, &lb, &h, &has_handle};
  cudaKernelNodeParams p{};
  p.func = reinterpret_cast<void*>(goal_loop_kernel);
  p.gridDim = dim3(1);
  p.blockDim = dim3(1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  cudaGraphNode_t d = static_cast<cudaGraphNode_t>(dep);
  return static_cast<int>(cudaGraphAddKernelNode(
      reinterpret_cast<cudaGraphNode_t*>(node),
      static_cast<cudaGraph_t>(graph), d ? &d : nullptr, d ? 1 : 0, &p));
}

// A new conditional handle of `graph` (default 0, not reset at launch).
extern "C" int cc_graph_handle(void* graph, uint64_t* handle) {
  cudaGraphConditionalHandle h;
  cudaError_t err = cudaGraphConditionalHandleCreate(
      &h, static_cast<cudaGraph_t>(graph), 0, 0);
  *handle = h;
  return static_cast<int>(err);
}

// A conditional node (IF, or WHILE where is_while) on `handle` after
// `dep`; its body graph is returned in *body.
extern "C" int cc_graph_add_cond(void* graph, void* dep, int is_while,
                                 uint64_t handle, void** node, void** body) {
  cudaGraphNodeParams p{};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = is_while ? cudaGraphCondTypeWhile : cudaGraphCondTypeIf;
  p.conditional.size = 1;
  int rc = add_node(reinterpret_cast<cudaGraphNode_t*>(node),
                    static_cast<cudaGraph_t>(graph),
                    static_cast<cudaGraphNode_t>(dep), &p);
  if (rc != 0) return rc;
  *body = p.conditional.phGraph_out[0];
  return 0;
}

extern "C" int cc_graph_instantiate(void* graph, void** exec) {
  return static_cast<int>(cudaGraphInstantiate(
      reinterpret_cast<cudaGraphExec_t*>(exec),
      static_cast<cudaGraph_t>(graph), 0));
}

extern "C" int cc_graph_upload(void* exec, void* stream) {
  return static_cast<int>(cudaGraphUpload(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int cc_graph_launch(void* exec, void* stream) {
  return static_cast<int>(cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                          static_cast<cudaStream_t>(stream)));
}

extern "C" int cc_graph_exec_destroy(void* exec) {
  return static_cast<int>(
      cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec)));
}

// Installed and runtime CUDA versions (CUDA 12.4 is 12040).
extern "C" int cc_cuda_versions(int* installed, int* runtime) {
  cudaError_t e = cudaDriverGetVersion(installed);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaRuntimeGetVersion(runtime));
}
