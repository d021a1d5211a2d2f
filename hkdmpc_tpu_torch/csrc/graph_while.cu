// The loops that stop of the HS-DDP solve as one CUDA graph with two nested
// conditional while nodes: the port's counterpart of the JAX package's
// `lax.while_loop` solve (hkdmpc_tpu/solver/ddp.py, `solve` with
// unroll_caps=False, compiled by `solve_jit` / the jitted `solve_batch`).
//
// Not a port of a TPU kernel: the JAX package has no Pallas kernel here, XLA
// builds the while loops itself. The pieces of the loop body are captured by
// torch (hkdmpc_tpu_torch/solver/graphs.py, `WhileSolve`), each a cudaGraph_t
// that reads and writes only static buffers; this file puts them into
// one parent graph:
//
//   carry0 -> set_cond(outer) -> while outer {
//       head -> set_cond(inner) -> while inner { inner -> set_cond(inner) }
//       -> tail -> set_cond(outer) }
//
// Each piece is a child graph node (a clone of torch's graph). Each piece
// ends by writing its loop's condition into a device flag (a bool), and the
// one-thread kernel `set_cond` copies that flag into the conditional handle
// (cudaGraphSetConditional). The set_cond nodes are kernel nodes of the body
// graphs themselves, not of a child graph. A while node evaluates its handle
// before each run of its body, so a flag set to false before the node runs
// the body no time.
//
// The graph calls use the runtime API of the toolkit this library is built
// with; the pieces' graphs come from torch's runtime: both are CUgraph
// objects of the device's primary context.
//
// C interface, bound with ctypes:
//   graph_while_build(carry0, head, inner, tail, flag_ou, flag_in, &exec,
//                     nodes[3], msg, msg_len): 0, or the cudaError_t of the
//                     first step that failed, named in msg;
//   graph_while_launch(exec, stream), graph_while_destroy(exec),
//   graph_while_error_string(err).

#include <cuda_runtime.h>

#include <cstdio>

__global__ void set_cond(cudaGraphConditionalHandle handle,
                         const bool* flag) {
  cudaGraphSetConditional(handle, *flag ? 1u : 0u);
}

namespace {

struct Assembler {
  char* msg;
  int msg_len;
  cudaError_t err = cudaSuccess;

  bool ok(cudaError_t e, const char* step) {
    if (e != cudaSuccess && err == cudaSuccess) {
      err = e;
      if (msg != nullptr && msg_len > 0)
        snprintf(msg, msg_len, "%s: %s (%s)", step, cudaGetErrorName(e),
                 cudaGetErrorString(e));
    }
    return err == cudaSuccess;
  }

  // `g`'s nodes in a chain: each node added depends on the one before
  // (`last`, null for the first).
  bool child(cudaGraph_t g, cudaGraphNode_t* last, cudaGraph_t piece,
             const char* step) {
    cudaGraphNode_t n;
    if (!ok(cudaGraphAddChildGraphNode(&n, g, *last ? last : nullptr,
                                       *last ? 1 : 0, piece),
            step))
      return false;
    *last = n;
    return true;
  }

  bool cond(cudaGraph_t g, cudaGraphNode_t* last,
            cudaGraphConditionalHandle handle, const bool* flag,
            const char* step) {
    void* args[] = {&handle, &flag};
    cudaKernelNodeParams p = {};
    p.func = reinterpret_cast<void*>(set_cond);
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    p.extra = nullptr;
    cudaGraphNode_t n;
    if (!ok(cudaGraphAddKernelNode(&n, g, *last ? last : nullptr,
                                   *last ? 1 : 0, &p),
            step))
      return false;
    *last = n;
    return true;
  }

  // a while node on `handle` after `last`; its (empty) body graph in *body
  bool loop(cudaGraph_t g, cudaGraphNode_t* last,
            cudaGraphConditionalHandle handle, cudaGraph_t* body,
            const char* step) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = handle;
    p.conditional.type = cudaGraphCondTypeWhile;
    p.conditional.size = 1;
    cudaGraphNode_t n;
    if (!ok(cudaGraphAddNode(&n, g, *last ? last : nullptr, *last ? 1 : 0,
                             &p),
            step))
      return false;
    *body = p.conditional.phGraph_out[0];
    *last = n;
    return true;
  }
};

int count_nodes(cudaGraph_t g) {
  size_t n = 0;
  return cudaGraphGetNodes(g, nullptr, &n) == cudaSuccess
             ? static_cast<int>(n)
             : -1;
}

}  // namespace

extern "C" int graph_while_build(void* carry0, void* head, void* inner,
                                 void* tail, const void* flag_ou,
                                 const void* flag_in, void** exec_out,
                                 int* nodes_out, char* msg, int msg_len) {
  Assembler b{msg, msg_len};
  const bool* f_ou = static_cast<const bool*>(flag_ou);
  const bool* f_in = static_cast<const bool*>(flag_in);
  cudaGraph_t parent = nullptr, body_ou = nullptr, body_in = nullptr;
  cudaGraphConditionalHandle h_ou = 0, h_in = 0;
  cudaGraphNode_t last = nullptr, last_ou = nullptr, last_in = nullptr;
  *exec_out = nullptr;

  if (!b.ok(cudaGraphCreate(&parent, 0), "cudaGraphCreate (parent)"))
    return b.err;
  bool done =
      b.ok(cudaGraphConditionalHandleCreate(&h_ou, parent, 0, 0),
           "cudaGraphConditionalHandleCreate (outer)") &&
      b.child(parent, &last, static_cast<cudaGraph_t>(carry0),
              "cudaGraphAddChildGraphNode (carry0)") &&
      b.cond(parent, &last, h_ou, f_ou,
             "cudaGraphAddKernelNode (set_cond outer, parent)") &&
      b.loop(parent, &last, h_ou, &body_ou,
             "cudaGraphAddNode (outer while node)") &&
      // the outer body
      b.ok(cudaGraphConditionalHandleCreate(&h_in, body_ou, 0, 0),
           "cudaGraphConditionalHandleCreate (inner)") &&
      b.child(body_ou, &last_ou, static_cast<cudaGraph_t>(head),
              "cudaGraphAddChildGraphNode (head)") &&
      b.cond(body_ou, &last_ou, h_in, f_in,
             "cudaGraphAddKernelNode (set_cond inner, outer body)") &&
      b.loop(body_ou, &last_ou, h_in, &body_in,
             "cudaGraphAddNode (inner while node)") &&
      // the inner body
      b.child(body_in, &last_in, static_cast<cudaGraph_t>(inner),
              "cudaGraphAddChildGraphNode (inner)") &&
      b.cond(body_in, &last_in, h_in, f_in,
             "cudaGraphAddKernelNode (set_cond inner, inner body)") &&
      // the outer body's tail
      b.child(body_ou, &last_ou, static_cast<cudaGraph_t>(tail),
              "cudaGraphAddChildGraphNode (tail)") &&
      b.cond(body_ou, &last_ou, h_ou, f_ou,
             "cudaGraphAddKernelNode (set_cond outer, outer body)");
  if (done) {
    nodes_out[0] = count_nodes(parent);
    nodes_out[1] = count_nodes(body_ou);
    nodes_out[2] = count_nodes(body_in);
    cudaGraphExec_t exec = nullptr;
    if (b.ok(cudaGraphInstantiate(&exec, parent, 0),
             "cudaGraphInstantiate (parent)"))
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

extern "C" const char* graph_while_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
