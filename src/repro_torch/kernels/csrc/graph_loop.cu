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
//
// The masked schedule loop (replaces the lax.while_loop of _run_schedule_while,
// src/repro/core/engine_persistent.py:504-604, which masks every buffer with
// jnp.where each iteration) runs N composed programs, each to its own count
// or predicate, in one launch:
//
//   init(active = 1, n_done = 0, reductions = 0, iter = 0) -> WHILE(loop) {
//       pass A -> sched_step(sets pair, restore_a[k], snapshot_a[k], flag)
//              -> IF(restore_a[k]){..} IF(snapshot_a[k]){..}  (each k)
//              -> IF(pair){ pass B -> sched_step(sets restore_b[k],
//                           snapshot_b[k], flag) -> IF nodes of B }
//              -> join(loop = flag) }
//   -> parity(iter) -> IF(even){ select_even } -> IF(odd){ select_odd }
//
// Every pass runs every program (a frozen program's packs keep publishing its
// frozen boundary).  The schedule step (one warp, a thread a program, k < 32)
// does what the reference's body does after its pass: where active[k], the
// pass's reduction red[k] goes to reductions[k][iter]; n_done[k] += active[k];
// keep[k] = active[k] && n_done[k] < n_iters[k] && (pred[k] if k has a
// predicate); active <- keep; iter += 1; the loop goes on iff any(keep) &&
// iter < max_iters.  It also sets two IF handles a program: snapshot[k] on the
// trip where k stops (its results are copied aside) and restore[k] on every
// trip that ran while k was frozen (the copies are put back where the next
// pass and the final select read k's buffers), so the pass's writes into a
// frozen program's buffers, its own and its neighbours' deposits alike, are
// discarded.  Each handle is created in the graph that holds its IF node and
// set by the step kernel of that graph.  Bound: per program it reads 13 bytes
// and writes 12, so its cost is its launch, as loop_step's.

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

constexpr int kMaxPrograms = 32;

// The schedule step's arguments, passed by value (about 800 bytes).
struct SchedStep {
  const float* red;            // [n_programs] the pass's reductions
  const unsigned char* pred;   // [n_programs] the pass's predicates (bool)
  int* active;                 // [n_programs]
  int* n_done;                 // [n_programs]
  float* reductions;           // [n_programs][max_iters]
  int* iter;                   // passes run by this launch
  int* flag;                   // the loop's decision, for the join
  int n_programs;
  int max_iters;
  unsigned int reduce_mask;    // bit k: program k has a reduction
  unsigned int until_mask;     // bit k: program k has a predicate
  unsigned int freeze_mask;    // bit k: program k has snapshot/restore bodies
  int set_pair;
  int n_iters[kMaxPrograms];
  cudaGraphConditionalHandle pair;
  cudaGraphConditionalHandle restore[kMaxPrograms];
  cudaGraphConditionalHandle snapshot[kMaxPrograms];
};

__global__ void sched_step(SchedStep s) {
  const int k = threadIdx.x;
  const int i = *s.iter;
  int keep = 0;
  if (k < s.n_programs) {
    const int a = s.active[k] != 0;
    if (a && ((s.reduce_mask >> k) & 1u) && i < s.max_iters)
      s.reductions[k * s.max_iters + i] = s.red[k];
    const int n = s.n_done[k] + a;
    s.n_done[k] = n;
    keep = a && n < s.n_iters[k] && (((s.until_mask >> k) & 1u) ? s.pred[k] != 0 : 1);
    s.active[k] = keep;
    if ((s.freeze_mask >> k) & 1u) {
      cudaGraphSetConditional(s.restore[k], a ? 0u : 1u);
      cudaGraphSetConditional(s.snapshot[k], (a && !keep) ? 1u : 0u);
    }
  }
  const int any = __syncthreads_or(keep);
  if (k == 0) {
    const int n = i + 1;
    *s.iter = n;
    const unsigned int go = (any && n < s.max_iters) ? 1u : 0u;
    *s.flag = static_cast<int>(go);
    if (s.set_pair) cudaGraphSetConditional(s.pair, go);
  }
}

__global__ void sched_init(int* __restrict__ active, int* __restrict__ n_done,
                           float* __restrict__ reductions, int* __restrict__ iter,
                           int n_programs, int n_reductions) {
  for (int t = threadIdx.x; t < n_reductions; t += blockDim.x) reductions[t] = 0.0f;
  for (int k = threadIdx.x; k < n_programs; k += blockDim.x) {
    active[k] = 1;
    n_done[k] = 0;
  }
  if (threadIdx.x == 0) *iter = 0;
}

cudaError_t add_kernel(cudaGraphNode_t* node, cudaGraph_t graph, cudaGraphNode_t dep,
                       void* func, void** args, int threads = 1) {
  cudaKernelNodeParams p = {};
  p.func = func;
  p.gridDim = dim3(1, 1, 1);
  p.blockDim = dim3(threads, 1, 1);
  p.sharedMemBytes = 0;
  p.kernelParams = args;
  p.extra = nullptr;
  return cudaGraphAddKernelNode(node, graph, &dep, dep ? 1 : 0, &p);
}

cudaError_t add_conditional(cudaGraphNode_t* node, cudaGraph_t graph,
                            const cudaGraphNode_t* deps, size_t n_deps,
                            cudaGraphConditionalHandle handle,
                            cudaGraphConditionalNodeType type, cudaGraph_t* body) {
  cudaGraphNodeParams p = {};
  p.type = cudaGraphNodeTypeConditional;
  p.conditional.handle = handle;
  p.conditional.type = type;
  p.conditional.size = 1;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaGraphAddNode(node, graph, deps, nullptr, n_deps, &p);
#else
  cudaError_t e = cudaGraphAddNode(node, graph, deps, n_deps, &p);
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
  TRY(add_conditional(&node, graph, &dep, 1, handle, cudaGraphCondTypeIf, &if_body));
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
  TRY(add_conditional(&loop, graph, &reset_r, 1, h_loop, cudaGraphCondTypeWhile, &body));
  TRY(cudaGraphAddChildGraphNode(&a, body, nullptr, 0, pass_a));
  TRY(cudaGraphConditionalHandleCreate(&h_pair, body, 0, cudaGraphCondAssignDefault));
  void* args_a[] = {&h_pair, &set, &red, &keep, &reductions, &n_done, &flag, &max_iters};
  TRY(add_kernel(&step, body, a, reinterpret_cast<void*>(loop_step), args_a));
  TRY(add_conditional(&pair, body, &step, 1, h_pair, cudaGraphCondTypeIf, &pair_body));
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

// Creates in `graph` the handles of the restore and snapshot IF nodes of each
// program that has freeze bodies (a kernel's parameters are copied when its
// node is added, so the handles exist before the step that sets them).
cudaError_t create_freeze_handles(cudaGraph_t graph, SchedStep* s) {
  for (int k = 0; k < s->n_programs; ++k) {
    if (!((s->freeze_mask >> k) & 1u)) continue;
    TRY(cudaGraphConditionalHandleCreate(&s->restore[k], graph, 0, cudaGraphCondAssignDefault));
    TRY(cudaGraphConditionalHandleCreate(&s->snapshot[k], graph, 0,
                                         cudaGraphCondAssignDefault));
  }
  return cudaSuccess;
}

// Adds, after `dep`, IF(restore[k]){ restore body } and IF(snapshot[k]){
// snapshot body } for each program k that has them: freeze[4k + 2 pass + j],
// j 0 the restore and 1 the snapshot, pass 0 for A and 1 for B (all four
// given, checked by the entry point).  The new nodes are appended to `ends`.
cudaError_t add_freeze_nodes(cudaGraph_t graph, cudaGraphNode_t dep,
                             cudaGraph_t const* freeze, int pass, const SchedStep& s,
                             std::vector<cudaGraphNode_t>* ends) {
  for (int k = 0; k < s.n_programs; ++k) {
    if (!((s.freeze_mask >> k) & 1u)) continue;
    const cudaGraphConditionalHandle handles[2] = {s.restore[k], s.snapshot[k]};
    for (int j = 0; j < 2; ++j) {
      cudaGraph_t body = freeze[4 * k + 2 * pass + j];
      cudaGraphNode_t node, child;
      cudaGraph_t if_body;
      TRY(add_conditional(&node, graph, &dep, 1, handles[j], cudaGraphCondTypeIf, &if_body));
      TRY(cudaGraphAddChildGraphNode(&child, if_body, nullptr, 0, body));
      ends->push_back(node);
    }
  }
  return cudaSuccess;
}

// Builds the masked schedule loop's outer graph into `graph` (the caller's
// wrapper creates it).  `s` holds the pointers, counts and masks; the handles
// are filled in here.
cudaError_t build_schedule(cudaGraph_t graph, cudaGraph_t pass_a, cudaGraph_t pass_b,
                           cudaGraph_t const* freeze, cudaGraph_t select_even,
                           cudaGraph_t select_odd, SchedStep s) {
  cudaGraphNode_t init, loop, a, step, pair, b, step_b, join, parity;
  cudaGraph_t body, pair_body;
  cudaGraphConditionalHandle h_loop, h_even = 0, h_odd = 0;
  int n_reductions = s.n_programs * s.max_iters;
  void* args_init[] = {&s.active, &s.n_done, &s.reductions, &s.iter, &s.n_programs,
                       &n_reductions};
  TRY(add_kernel(&init, graph, nullptr, reinterpret_cast<void*>(sched_init), args_init, 256));
  TRY(cudaGraphConditionalHandleCreate(&h_loop, graph, 1, cudaGraphCondAssignDefault));
  TRY(add_conditional(&loop, graph, &init, 1, h_loop, cudaGraphCondTypeWhile, &body));
  // pass A, its step, its freeze nodes, then the IF node of pass B after all
  SchedStep sa = s;
  sa.set_pair = 1;
  TRY(cudaGraphConditionalHandleCreate(&sa.pair, body, 0, cudaGraphCondAssignDefault));
  TRY(create_freeze_handles(body, &sa));
  TRY(cudaGraphAddChildGraphNode(&a, body, nullptr, 0, pass_a));
  void* args_a[] = {&sa};
  TRY(add_kernel(&step, body, a, reinterpret_cast<void*>(sched_step), args_a, kMaxPrograms));
  std::vector<cudaGraphNode_t> ends;
  TRY(add_freeze_nodes(body, step, freeze, 0, sa, &ends));
  if (ends.empty()) ends.push_back(step);
  TRY(add_conditional(&pair, body, ends.data(), ends.size(), sa.pair, cudaGraphCondTypeIf,
                      &pair_body));
  // inside the pair: pass B, its step and its freeze nodes
  SchedStep sb = s;
  sb.set_pair = 0;
  TRY(create_freeze_handles(pair_body, &sb));
  TRY(cudaGraphAddChildGraphNode(&b, pair_body, nullptr, 0, pass_b));
  void* args_b[] = {&sb};
  TRY(add_kernel(&step_b, pair_body, b, reinterpret_cast<void*>(sched_step), args_b,
                 kMaxPrograms));
  std::vector<cudaGraphNode_t> ends_b;
  TRY(add_freeze_nodes(pair_body, step_b, freeze, 1, sb, &ends_b));
  void* args_join[] = {&h_loop, &s.flag};
  TRY(add_kernel(&join, body, pair, reinterpret_cast<void*>(loop_join), args_join));
  // after the loop: the select of the last pass's parity (iter odd: pass A)
  int has_even = select_even != nullptr, has_odd = select_odd != nullptr;
  if (!has_even && !has_odd) return cudaSuccess;
  if (has_even) TRY(cudaGraphConditionalHandleCreate(&h_even, graph, 0, 0));
  if (has_odd) TRY(cudaGraphConditionalHandleCreate(&h_odd, graph, 0, 0));
  void* args_parity[] = {&h_even, &has_even, &h_odd, &has_odd, &s.iter};
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

// The masked schedule loop.  pass_a, pass_b: raw cudaGraph_t; freeze: 4 x
// n_programs raw cudaGraph_t (restore A, snapshot A, restore B, snapshot B of
// each program; any may be null); select_even, select_odd may be null.  red:
// float32 [n]; pred: bool [n]; active, n_done: int32 [n]; reductions: float32
// [n][max_iters]; iter, flag: int32 0-d; n_iters: n host ints.  Bit k of
// reduce_mask / until_mask: program k has a reduction / a predicate; of
// freeze_mask: program k has freeze bodies.  out as rt_graph_loop_build's.
int rt_schedule_loop_build(void* pass_a, void* pass_b, void** freeze, void* select_even,
                           void* select_odd, void* red, void* pred, void* active,
                           void* n_done, void* reductions, void* iter, void* flag,
                           const int* n_iters, int n_programs, int max_iters,
                           unsigned int reduce_mask, unsigned int until_mask,
                           unsigned int freeze_mask, void** out) {
  int installed = 0;
  cudaError_t e = cudaDriverGetVersion(&installed);
  if (e != cudaSuccess) return e;
  if (installed < 12040) return cudaErrorInsufficientDriver;
  if (max_iters < 1 || n_programs < 1 || n_programs > kMaxPrograms || pass_a == nullptr ||
      pass_b == nullptr)
    return cudaErrorInvalidValue;
  SchedStep s = {};
  s.red = static_cast<const float*>(red);
  s.pred = static_cast<const unsigned char*>(pred);
  s.active = static_cast<int*>(active);
  s.n_done = static_cast<int*>(n_done);
  s.reductions = static_cast<float*>(reductions);
  s.iter = static_cast<int*>(iter);
  s.flag = static_cast<int*>(flag);
  s.n_programs = n_programs;
  s.max_iters = max_iters;
  s.reduce_mask = reduce_mask;
  s.until_mask = until_mask;
  s.freeze_mask = freeze_mask;
  for (int k = 0; k < n_programs; ++k) {
    s.n_iters[k] = n_iters[k];
    for (int j = 0; j < 4 && ((freeze_mask >> k) & 1u); ++j)
      if (freeze[4 * k + j] == nullptr) return cudaErrorInvalidValue;
  }
  if (n_programs < kMaxPrograms && (freeze_mask >> n_programs) != 0) return cudaErrorInvalidValue;
  cudaGraph_t graph = nullptr;
  if ((e = cudaGraphCreate(&graph, 0)) != cudaSuccess) return e;
  e = build_schedule(graph, static_cast<cudaGraph_t>(pass_a), static_cast<cudaGraph_t>(pass_b),
                     reinterpret_cast<cudaGraph_t const*>(freeze),
                     static_cast<cudaGraph_t>(select_even), static_cast<cudaGraph_t>(select_odd),
                     s);
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
