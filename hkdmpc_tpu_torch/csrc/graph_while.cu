// The device programs of the HS-DDP solve and of the MPC steps: torch-captured
// pieces assembled into one CUDA graph, each loop that stops a conditional
// while node. The port's counterpart of the JAX package's compiled programs
// with their `lax.while_loop`s (hkdmpc_tpu/solver/ddp.py and
// hkdmpc_tpu/solver/backward.py: the AL and DDP loops with unroll_caps=False,
// the regularization retry of every backward sweep).
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here, XLA
// builds the while loops itself. The pieces are captured by torch
// (hkdmpc_tpu_torch/solver/graphs.py, `SolveProgram`), each a cudaGraph_t
// that reads and writes only static buffers and ends by writing its loop's
// condition into a device flag (a bool). The program says in which order
// they run, as int32 items:
//
//   0 i        the piece i, a child graph node (a clone of torch's graph);
//   1 j n ...  while flag j { the next n ints: items }, nested to any depth.
//
// A piece may be named any number of times (the unrolled loops). For a while
// item the builder adds, in the graph being built, a one-thread kernel node
// `set_cond` that copies flag j into a new conditional handle, then the
// while node on that handle; in the node's body graph the body's items and,
// last, another `set_cond` of the same flag and handle. A while node
// evaluates its handle before each run of its body, so a flag that is false
// before the node runs the body no time. Conditional and set_cond nodes sit
// only in the parent graph and in body graphs: a child graph node may not
// hold a conditional node, and the pieces are only ever leaves.
//
// The graph calls use the runtime API of the toolkit this library is built
// with; the pieces' graphs come from torch's runtime: both are CUgraph
// objects of the device's primary context.
//
// C interface, bound with ctypes:
//   graph_program_build(pieces[n_pieces], n_pieces, flags[n_flags], n_flags,
//                       program[len], len, &exec, level_nodes[max_levels],
//                       max_levels, msg, msg_len): 0, or the cudaError_t of
//                       the first step that failed, named in msg (a
//                       malformed program: cudaErrorInvalidValue);
//                       level_nodes[d] the nodes of the graphs at nesting
//                       depth d (0: the parent);
//   graph_while_launch(exec, stream), graph_while_destroy(exec),
//   graph_while_error_string(err);
//   stage_lap_launch(meter, n_pieces, piece, stage, n_stages, rows, stream):
//                       one lap of a program's stage clock (below) on
//                       `stream`, where a capture records it as one more
//                       kernel node;
//   clock_stamp_launch(out, stream): the device's %globaltimer into out[0].
//
// The meter of a device program is one int64 buffer: the runs, 2 rows of
// n_pieces (each piece's runs since the program was made, and in the last
// replay), then the stage clock, 1 + rows rows of 2 + n_stages: the head
// (replays begun, the last stamp, then the laps run per stage) and a ring
// of rows, one per replay (row k % rows for replay k, from 0): the replay's
// first and last stamp, then the ns of each stage. A lap reads %globaltimer
// and adds the time since the last stamp to the slot of the stage that just
// ended, so the stages of a replay sum to its last stamp less its first;
// stage -1 begins a replay (zeroes its row and the last replay's runs). A
// lap with piece >= 0 ends that piece and counts its run, so a piece's end
// costs one node; a replay's begin counts no piece.

#include <cuda_runtime.h>

#include <cstdio>

__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

__device__ __forceinline__ long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return static_cast<long long>(t);
}

__global__ void stage_lap(long long* meter, int n_pieces, int piece,
                          int stage, int n_stages, int rows) {
  const long long t = global_ns();
  long long* runs = meter;
  long long* clock = meter + 2 * n_pieces;
  const int width = 2 + n_stages;
  long long* ring = clock + width;
  const long long n = clock[0];
  if (stage < 0) {
    long long* row = ring + (n % rows) * width;
    for (int p = 0; p < n_pieces; ++p) runs[n_pieces + p] = 0;
    for (int s = 0; s < n_stages; ++s) row[2 + s] = 0;
    row[0] = row[1] = t;
    clock[0] = n + 1;
    clock[1] = t;
    return;
  }
  // every load before the first store, so that the loads go out together
  // (the slots differ: no store here feeds a load of this lap)
  long long* row = ring + ((n > 0 ? n - 1 : 0) % rows) * width;
  const long long prev = clock[1], laps = clock[2 + stage];
  const long long ns = row[2 + stage];
  long long r0 = 0, r1 = 0;
  if (piece >= 0) {
    r0 = runs[piece];
    r1 = runs[n_pieces + piece];
  }
  row[2 + stage] = ns + (t - prev);
  row[1] = t;
  clock[2 + stage] = laps + 1;
  clock[1] = t;
  if (piece >= 0) {
    runs[piece] = r0 + 1;
    runs[n_pieces + piece] = r1 + 1;
  }
}

__global__ void clock_stamp(long long* out) { out[0] = global_ns(); }

namespace {

int count_nodes(cudaGraph_t g) {
  size_t n = 0;
  return cudaGraphGetNodes(g, nullptr, &n) == cudaSuccess
             ? static_cast<int>(n)
             : -1;
}

struct Assembler {
  cudaGraph_t* pieces;
  int n_pieces;
  const bool* const* flags;
  int n_flags;
  const int* prog;
  int* level_nodes;
  int max_levels;
  char* msg;
  int msg_len;
  cudaError_t err = cudaSuccess;

  bool ok(cudaError_t e, const char* step, int at) {
    if (e != cudaSuccess && err == cudaSuccess) {
      err = e;
      if (msg != nullptr && msg_len > 0)
        snprintf(msg, msg_len, "%s (program item at %d): %s (%s)", step, at,
                 cudaGetErrorName(e), cudaGetErrorString(e));
    }
    return err == cudaSuccess;
  }

  // `g`'s nodes in a chain: each node added depends on the one before
  // (`last`, null for the first).
  bool child(cudaGraph_t g, cudaGraphNode_t* last, int i, int at) {
    cudaGraphNode_t n;
    char step[96];
    snprintf(step, sizeof step, "cudaGraphAddChildGraphNode (piece %d)", i);
    if (!ok(cudaGraphAddChildGraphNode(&n, g, *last ? last : nullptr,
                                       *last ? 1 : 0, pieces[i]),
            step, at))
      return false;
    *last = n;
    return true;
  }

  bool cond(cudaGraph_t g, cudaGraphNode_t* last,
            cudaGraphConditionalHandle handle, int j, int at) {
    const bool* flag = flags[j];
    void* args[] = {&handle, &flag};
    cudaKernelNodeParams p = {};
    p.func = reinterpret_cast<void*>(set_cond);
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    p.extra = nullptr;
    cudaGraphNode_t n;
    char step[96];
    snprintf(step, sizeof step, "cudaGraphAddKernelNode (set_cond, flag %d)",
             j);
    if (!ok(cudaGraphAddKernelNode(&n, g, *last ? last : nullptr,
                                   *last ? 1 : 0, &p),
            step, at))
      return false;
    *last = n;
    return true;
  }

  // a while node on `handle` after `last`; its (empty) body graph in *body
  bool loop(cudaGraph_t g, cudaGraphNode_t* last,
            cudaGraphConditionalHandle handle, cudaGraph_t* body, int j,
            int at) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handle;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t n;
    char step[96];
    snprintf(step, sizeof step, "cudaGraphAddNode (while node, flag %d)", j);
    if (!ok(cudaGraphAddNode(&n, g, *last ? last : nullptr, *last ? 1 : 0,
                             &p),
            step, at))
      return false;
    *body = p.conditional.phGraph_out[0];
    *last = n;
    return true;
  }

  bool malformed(const char* what, int at) {
    return ok(cudaErrorInvalidValue, what, at);
  }

  // the items prog[pos, end) into `g` (nesting depth `depth`), chained
  // after *last
  bool items(cudaGraph_t g, int pos, int end, int depth,
             cudaGraphNode_t* last) {
    while (pos < end) {
      if (prog[pos] == 0 && pos + 2 <= end) {
        int i = prog[pos + 1];
        if (i < 0 || i >= n_pieces) return malformed("piece index", pos);
        if (!child(g, last, i, pos)) return false;
        pos += 2;
      } else if (prog[pos] == 1 && pos + 3 <= end) {
        int j = prog[pos + 1], n = prog[pos + 2];
        if (j < 0 || j >= n_flags) return malformed("flag index", pos);
        if (n < 0 || pos + 3 + n > end) return malformed("body length", pos);
        if (depth + 1 >= max_levels) return malformed("nesting depth", pos);
        cudaGraphConditionalHandle h = 0;
        cudaGraph_t body = nullptr;
        cudaGraphNode_t body_last = nullptr;
        if (!ok(cudaGraphConditionalHandleCreate(&h, g, 0, 0),
                "cudaGraphConditionalHandleCreate", pos) ||
            !cond(g, last, h, j, pos) || !loop(g, last, h, &body, j, pos) ||
            !items(body, pos + 3, pos + 3 + n, depth + 1, &body_last) ||
            !cond(body, &body_last, h, j, pos))
          return false;
        level_nodes[depth + 1] += count_nodes(body);
        pos += 3 + n;
      } else {
        return malformed("item code", pos);
      }
    }
    return true;
  }
};

}  // namespace

extern "C" int graph_program_build(void** pieces, int n_pieces,
                                   const void** flags, int n_flags,
                                   const int* program, int len,
                                   void** exec_out, int* level_nodes,
                                   int max_levels, char* msg, int msg_len) {
  Assembler b{reinterpret_cast<cudaGraph_t*>(pieces),
              n_pieces,
              reinterpret_cast<const bool* const*>(flags),
              n_flags,
              program,
              level_nodes,
              max_levels,
              msg,
              msg_len};
  *exec_out = nullptr;
  for (int d = 0; d < max_levels; ++d) level_nodes[d] = 0;
  cudaGraph_t parent = nullptr;
  if (!b.ok(cudaGraphCreate(&parent, 0), "cudaGraphCreate (parent)", 0))
    return b.err;
  cudaGraphNode_t last = nullptr;
  if (b.items(parent, 0, len, 0, &last)) {
    level_nodes[0] = count_nodes(parent);
    cudaGraphExec_t exec = nullptr;
    if (b.ok(cudaGraphInstantiate(&exec, parent, 0),
             "cudaGraphInstantiate (parent)", 0))
      *exec_out = exec;
  }
  cudaGraphDestroy(parent);  // the body graphs belong to their nodes
  return b.err;
}

extern "C" int graph_while_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec),
                         static_cast<cudaStream_t>(stream));
}

extern "C" int graph_while_destroy(void* exec) {
  return cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
}

extern "C" int stage_lap_launch(void* meter, int n_pieces, int piece,
                                int stage, int n_stages, int rows,
                                void* stream) {
  stage_lap<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(meter), n_pieces, piece, stage, n_stages,
      rows);
  return cudaGetLastError();
}

extern "C" int clock_stamp_launch(void* out, void* stream) {
  clock_stamp<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<long long*>(out));
  return cudaGetLastError();
}

extern "C" const char* graph_while_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
