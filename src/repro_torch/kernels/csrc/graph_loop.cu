// Hopper (sm_90a) device-resident convergence loop, with a plain C interface:
// a CUDA-graph conditional WHILE node whose body is a captured pass of an ST
// program, and the step kernel that decides on the device whether it runs
// again.
//
// Replaces the jax.lax.while_loop of _run_persistent_while
// (src/repro/core/engine_persistent.py:495).  The reference has no Pallas
// kernel there: XLA keeps the loop's predicate on the device, and so does this
// graph.  The host launches it once and reads nothing until it has ended.
//
// The outer graph (WHILE needs CUDA 12.4 or later, both at build and installed):
//
//   memset n_done = 0 -> memset reductions = 0 -> WHILE(loop, default 1) {
//       pass A -> step(sets pair, flag) -> IF(pair){ pass B -> step(flag) }
//              -> join(loop = flag) }
//   -> parity(even = n_done is even, odd = not) -> IF(even){ select_even }
//                                               -> IF(odd){ select_odd }
//
// Pass A and pass B are graphs that PyTorch captured (kept with keep_graph=True
// and handed over as raw cudaGraph_t); each is cloned in as a child-graph
// node.  Their addresses are fixed by the capture, so each pass leaves its
// scalar reduction and its predicate at fixed addresses, where the step kernel
// reads them.  Two passes a trip let pass B read what pass A left where A left
// it, and put it back where A reads it, so the caller's buffers are rewritten
// once a trip, not once a pass; the last realized pass is A's when n_done is
// odd and B's when it is even, and the select graph of that parity (either
// may be absent) puts its results where the caller reads them.  The first
// trip always runs (the WHILE handle's default is 1, assigned at every launch).
//
// The step kernel (one thread): reductions[n_done] = red; n_done += 1; the loop
// goes on iff keep && n_done < max_iters.  Bound: it moves 21 bytes, so what it
// costs is its launch inside the graph; one thread and no shared memory keep
// that launch as small as a launch can be.  The step after pass A sets the IF
// node's handle (cudaGraphSetConditional) and writes its decision to `flag`,
// the step inside the IF body writes its own decision there, and a join kernel
// hands `flag` to the WHILE handle (each kernel sets a handle of the graph
// that holds it).

#include <cuda_runtime.h>
#include <cstdint>
#include <unordered_map>
#include <vector>

#if !defined(CUDART_VERSION) || CUDART_VERSION < 12040
#error "graph_loop.cu needs CUDA 12.4 or later: conditional WHILE nodes"
#endif

namespace {

__global__ void loop_step(cudaGraphConditionalHandle handle, int set_handle,
                          const float* __restrict__ red,
                          const unsigned char* __restrict__ keep,
                          float* __restrict__ reductions, int* __restrict__ n_done,
                          int* __restrict__ flag, int max_iters) {
  const int i = *n_done;
  if (i < max_iters) reductions[i] = *red;
  const int n = i + 1;
  *n_done = n;
  const unsigned int go = (*keep != 0 && n < max_iters) ? 1u : 0u;
  *flag = static_cast<int>(go);
  if (set_handle) cudaGraphSetConditional(handle, go);
}

__global__ void loop_join(cudaGraphConditionalHandle handle, const int* __restrict__ flag) {
  cudaGraphSetConditional(handle, *flag != 0 ? 1u : 0u);
}

__global__ void loop_parity(cudaGraphConditionalHandle even, int has_even,
                            cudaGraphConditionalHandle odd, int has_odd,
                            const int* __restrict__ n_done) {
  const unsigned int is_even = (*n_done % 2 == 0) ? 1u : 0u;
  if (has_even) cudaGraphSetConditional(even, is_even);
  if (has_odd) cudaGraphSetConditional(odd, 1u - is_even);
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                       void* func, void** args) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(1, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, &dep, 1, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, nullptr, 1, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, &dep, 1, &p);
#endif
  if (e == cudaSuccess) *body = p.conditional.phGraph_out[0];
  return e;
}

cudaError_t add_memset(cudaGraphNode_t* node, cudaGraph_t graph, const cudaGraphNode_t* dep,
                       void* dst, size_t words) {
  cudaMemsetParams m = {};
  m.dst = dst;
  m.value = 0;
  m.elementSize = 4;
  m.width = words;
  m.height = 1;
  m.pitch = 0;
  return cudaGraphAddMemsetNode(node, graph, dep, dep ? 1 : 0, &m);
}

#define TRY(call)                          \
  do {                                     \
    cudaError_t e_ = (call);               \
    if (e_ != cudaSuccess) return e_;      \
  } while (0)

// Adds IF(handle){ body } after `dep` when `body` is given.
cudaError_t add_select(cudaGraph_t graph, cudaGraphNode_t dep,
                       cudaGraphConditionalHandle handle, cudaGraph_t body) {
  if (body == nullptr) return cudaSuccess;
  cudaGraphNode_t node, child;
  cudaGraph_t if_body;
  TRY(add_conditional(&node, graph, dep, handle, cudaGraphCondTypeIf, &if_body));
  return cudaGraphAddChildGraphNode(&child, if_body, nullptr, 0, body);
}

// Builds the outer graph into `graph` (created by the caller's wrapper).
cudaError_t build(cudaGraph_t graph, cudaGraph_t pass_a, cudaGraph_t pass_b,
                  cudaGraph_t select_even, cudaGraph_t select_odd, const float* red,
                  const unsigned char* keep, float* reductions, int* n_done, int* flag,
                  int max_iters) {
  cudaGraphNode_t reset_n, reset_r, loop, a, step, pair, b, step_b, join, parity;
  cudaGraph_t body, pair_body;
  cudaGraphConditionalHandle h_loop, h_pair, h_even = 0, h_odd = 0;
  int set = 1, unset = 0;
  int has_even = select_even != nullptr, has_odd = select_odd != nullptr;
  TRY(add_memset(&reset_n, graph, nullptr, n_done, 1));
  TRY(add_memset(&reset_r, graph, &reset_n, reductions, static_cast<size_t>(max_iters)));
  TRY(cudaGraphConditionalHandleCreate(&h_loop, graph, 1, cudaGraphCondAssignDefault));
  TRY(add_conditional(&loop, graph, reset_r, h_loop, cudaGraphCondTypeWhile, &body));
  TRY(cudaGraphAddChildGraphNode(&a, body, nullptr, 0, pass_a));
  TRY(cudaGraphConditionalHandleCreate(&h_pair, body, 0, cudaGraphCondAssignDefault));
  void* args_a[] = {&h_pair, &set, &red, &keep, &reductions, &n_done, &flag, &max_iters};
  TRY(add_kernel(&step, body, a, reinterpret_cast<void*>(loop_step), args_a));
  TRY(add_conditional(&pair, body, step, h_pair, cudaGraphCondTypeIf, &pair_body));
  TRY(cudaGraphAddChildGraphNode(&b, pair_body, nullptr, 0, pass_b));
  void* args_b[] = {&h_pair, &unset, &red, &keep, &reductions, &n_done, &flag, &max_iters};
  TRY(add_kernel(&step_b, pair_body, b, reinterpret_cast<void*>(loop_step), args_b));
  void* args_join[] = {&h_loop, &flag};
  TRY(add_kernel(&join, body, pair, reinterpret_cast<void*>(loop_join), args_join));
  if (!has_even && !has_odd) return cudaSuccess;
  if (has_even) TRY(cudaGraphConditionalHandleCreate(&h_even, graph, 0, 0));
  if (has_odd) TRY(cudaGraphConditionalHandleCreate(&h_odd, graph, 0, 0));
  void* args_parity[] = {&h_even, &has_even, &h_odd, &has_odd, &n_done};
  TRY(add_kernel(&parity, graph, loop, reinterpret_cast<void*>(loop_parity), args_parity));
  TRY(add_select(graph, parity, h_even, select_even));
  return add_select(graph, parity, h_odd, select_odd);
}

void count_nodes(cudaGraph_t graph, int* counts, int n_types, cudaError_t* err) {
  size_t n = 0;
  if ((*err = cudaGraphGetNodes(graph, nullptr, &n)) != cudaSuccess || n == 0) return;
  cudaGraphNode_t* nodes = new cudaGraphNode_t[n];
  if ((*err = cudaGraphGetNodes(graph, nodes, &n)) == cudaSuccess) {
    for (size_t i = 0; i < n && *err == cudaSuccess; ++i) {
      cudaGraphNodeType t;
      if ((*err = cudaGraphNodeGetType(nodes[i], &t)) != cudaSuccess) break;
      if (static_cast<int>(t) >= 0 && static_cast<int>(t) < n_types) ++counts[t];
      if (t == cudaGraphNodeTypeGraph) {
        cudaGraph_t child;
        if ((*err = cudaGraphChildGraphNodeGetGraph(nodes[i], &child)) != cudaSuccess) break;
        count_nodes(child, counts, n_types, err);
      }
    }
  }
  delete[] nodes;
}

}  // namespace

extern "C" {

const char* rt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// pass_a, pass_b, select_even, select_odd: raw cudaGraph_t (either select may
// be null).  red: float32 0-d; keep: bool 0-d; reductions: float32
// [max_iters]; n_done: int32 0-d; flag: int32 0-d scratch.  out[0] receives
// the cudaGraph_t, out[1] the cudaGraphExec_t.
int rt_graph_loop_build(void* pass_a, void* pass_b, void* select_even, void* select_odd,
                        void* red, void* keep, void* reductions, void* n_done, void* flag,
                        int max_iters, void** out) {
  int installed = 0;
  cudaError_t e = cudaDriverGetVersion(&installed);
  if (e != cudaSuccess) return e;
  if (installed < 12040) return cudaErrorInsufficientDriver;
  if (max_iters < 1 || pass_a == nullptr || pass_b == nullptr) return cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  if ((e = cudaGraphCreate(&graph, 0)) != cudaSuccess) return e;
  e = build(graph, static_cast<cudaGraph_t>(pass_a), static_cast<cudaGraph_t>(pass_b),
            static_cast<cudaGraph_t>(select_even), static_cast<cudaGraph_t>(select_odd),
            static_cast<const float*>(red), static_cast<const unsigned char*>(keep),
            static_cast<float*>(reductions), static_cast<int*>(n_done),
            static_cast<int*>(flag), max_iters);
  cudaGraphExec_t exec = nullptr;
  if (e == cudaSuccess) e = cudaGraphInstantiate(&exec, graph, 0);
  if (e != cudaSuccess) {
    cudaGraphDestroy(graph);
    return e;
  }
  out[0] = graph;
  out[1] = exec;
  return cudaSuccess;
}

int rt_graph_loop_launch(void* exec, void* stream) {
  cudaError_t e = cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                                  static_cast<cudaStream_t>(stream));
  return e != cudaSuccess ? e : cudaGetLastError();
}

int rt_graph_loop_destroy(void* graph, void* exec) {
  cudaError_t e = cudaSuccess;
  if (exec != nullptr) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph != nullptr) {
    cudaError_t g = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = g;
  }
  return e;
}

// counts[t] += the nodes of type t in `graph` and the child graphs it holds
// (t < n_types, cudaGraphNodeType's values).
int rt_graph_node_types(void* graph, int* counts, int n_types) {
  cudaError_t e = cudaSuccess;
  count_nodes(static_cast<cudaGraph_t>(graph), counts, n_types, &e);
  return e;
}

// The top-level nodes of `graph` (types[i]: cudaGraphNodeType of node i) and
// its dependency edges as node indices (from[k] -> to[k]).  sizes[0] and
// sizes[1] receive the counts of nodes and edges; if they exceed cap_nodes or
// cap_edges nothing else is written and cudaErrorInvalidValue is returned, so
// a caller asks once with no room and again with the room it was told.
int rt_graph_edges(void* graph, int* types, int cap_nodes, int* from, int* to,
                   int cap_edges, int* sizes) {
  cudaGraph_t g = static_cast<cudaGraph_t>(graph);
  size_t n = 0, m = 0;
  cudaError_t e = cudaGraphGetNodes(g, nullptr, &n);
  if (e == cudaSuccess) e = cudaGraphGetEdges(g, nullptr, nullptr, &m);
  if (e != cudaSuccess) return e;
  sizes[0] = static_cast<int>(n);
  sizes[1] = static_cast<int>(m);
  if (n > static_cast<size_t>(cap_nodes) || m > static_cast<size_t>(cap_edges))
    return cudaErrorInvalidValue;
  std::vector<cudaGraphNode_t> nodes(n), a(m), b(m);
  if (n > 0 && (e = cudaGraphGetNodes(g, nodes.data(), &n)) != cudaSuccess) return e;
  if (m > 0 && (e = cudaGraphGetEdges(g, a.data(), b.data(), &m)) != cudaSuccess) return e;
  std::unordered_map<cudaGraphNode_t, int> index;
  for (size_t i = 0; i < n; ++i) {
    index[nodes[i]] = static_cast<int>(i);
    cudaGraphNodeType t;
    if ((e = cudaGraphNodeGetType(nodes[i], &t)) != cudaSuccess) return e;
    types[i] = static_cast<int>(t);
  }
  for (size_t k = 0; k < m; ++k) {
    from[k] = index[a[k]];
    to[k] = index[b[k]];
  }
  return cudaSuccess;
}

}  // extern "C"
