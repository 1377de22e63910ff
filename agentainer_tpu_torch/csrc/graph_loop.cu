// A bounded on-device loop as one CUDA graph: the fused decode loop's
// runner on the card (engine/graphs.py::LoopGraph).
//
// Reference: agentainer_tpu/engine/llm.py::_fused_fn, a lax.while_loop whose
// bound is a runtime operand and whose exit is decided on the device. PyTorch
// captures straight-line graphs only, so the loop is assembled here from
// graphs it captured (each segment of one iteration, kept with
// keep_graph=True) around CUDA conditional nodes (CUDA >= 12.4):
//
//   set(loop, *cont) -> WHILE(loop) { [pre] -> set(v, *spec), set(p, !*spec)
//                                     -> IF(v) { verify }  IF(p) { plain }
//                                     -> [post] -> set(loop, *cont) }
//                    -> [tail]
//
// Without a verify segment the body is [pre] -> plain -> [post]. Each
// segment enters as a child graph node (a copy of the captured graph, whose
// kernels keep the addresses PyTorch's allocator gave them in the capture
// pool). cont and spec are device bools the segments write: the body's last
// segment computes cont, so the loop runs while it holds and the host never
// reads it. No host node and no host copy is part of the loop.

#include <cuda_runtime.h>

namespace {

__global__ void set_loop(cudaGraphConditionalHandle h, const bool* flag) {
  cudaGraphSetConditional(h, *flag ? 1u : 0u);
}

__global__ void set_branches(cudaGraphConditionalHandle on, cudaGraphConditionalHandle off,
                             const bool* flag) {
  const bool f = *flag;
  cudaGraphSetConditional(on, f ? 1u : 0u);
  cudaGraphSetConditional(off, f ? 0u : 1u);
}

struct Builder {
  cudaError_t err = cudaSuccess;

  bool ok(cudaError_t e) {
    if (err == cudaSuccess && e != cudaSuccess) err = e;
    return err == cudaSuccess;
  }

  // one node after `dep` (or at the root with dep == nullptr)
  cudaGraphNode_t child(cudaGraph_t g, cudaGraphNode_t dep, cudaGraph_t sub) {
    cudaGraphNode_t n = nullptr;
    ok(cudaGraphAddChildGraphNode(&n, g, dep ? &dep : nullptr, dep ? 1 : 0, sub));
    return n;
  }

  cudaGraphNode_t kernel(cudaGraph_t g, const cudaGraphNode_t* deps, size_t ndeps, void* fn,
                         void** args) {
    cudaKernelNodeParams p = {};
    p.func = fn;
    p.gridDim = dim3(1);
    p.blockDim = dim3(1);
    p.sharedMemBytes = 0;
    p.kernelParams = args;
    cudaGraphNode_t n = nullptr;
    ok(cudaGraphAddKernelNode(&n, g, deps, ndeps, &p));
    return n;
  }

  // a conditional node after deps; returns its body graph
  cudaGraph_t conditional(cudaGraph_t g, const cudaGraphNode_t* deps, size_t ndeps,
                          cudaGraphConditionalHandle h, cudaGraphConditionalNodeType type,
                          cudaGraphNode_t* node) {
    cudaGraphNodeParams p = {};
    p.type = cudaGraphNodeTypeConditional;
    p.conditional.handle = h;
    p.conditional.type = type;
    p.conditional.size = 1;
    *node = nullptr;
    if (!ok(cudaGraphAddNode(node, g, deps, ndeps, &p))) return nullptr;
    return p.conditional.phGraph_out[0];
  }
};

}  // namespace

extern "C" {

// Build and instantiate the loop graph. pre, verify, post and tail may be
// null; plain and cont may not; spec is read only with a verify segment.
// Returns a cudaError_t (0 on success); on success *exec_out and *graph_out
// hold the executable graph and its graph, for atpu_loop_launch and
// atpu_loop_destroy.
int atpu_loop_build(void* pre, void* verify, void* plain, void* post, void* tail,
                    const void* cont, const void* spec, void** exec_out, void** graph_out) {
  Builder b;
  *exec_out = nullptr;
  *graph_out = nullptr;
  cudaGraph_t g = nullptr;
  if (!b.ok(cudaGraphCreate(&g, 0))) return b.err;
  cudaGraphConditionalHandle loop = 0;
  b.ok(cudaGraphConditionalHandleCreate(&loop, g, 0, cudaGraphCondAssignDefault));
  const bool* cont_p = static_cast<const bool*>(cont);
  const bool* spec_p = static_cast<const bool*>(spec);
  void* entry_args[] = {&loop, &cont_p};
  cudaGraphNode_t entry = b.kernel(g, nullptr, 0, reinterpret_cast<void*>(set_loop), entry_args);
  cudaGraphNode_t wnode = nullptr;
  cudaGraph_t body = b.err == cudaSuccess
      ? b.conditional(g, &entry, 1, loop, cudaGraphCondTypeWhile, &wnode)
      : nullptr;
  if (b.err == cudaSuccess) {
    cudaGraphNode_t last = pre ? b.child(body, nullptr, static_cast<cudaGraph_t>(pre)) : nullptr;
    if (verify) {
      cudaGraphConditionalHandle on = 0, off = 0;
      b.ok(cudaGraphConditionalHandleCreate(&on, body, 0, cudaGraphCondAssignDefault));
      b.ok(cudaGraphConditionalHandleCreate(&off, body, 0, cudaGraphCondAssignDefault));
      void* args[] = {&on, &off, &spec_p};
      cudaGraphNode_t sel = b.kernel(body, last ? &last : nullptr, last ? 1 : 0,
                                     reinterpret_cast<void*>(set_branches), args);
      cudaGraphNode_t branches[2] = {nullptr, nullptr};
      cudaGraph_t vbody = b.conditional(body, &sel, 1, on, cudaGraphCondTypeIf, &branches[0]);
      cudaGraph_t pbody = b.conditional(body, &sel, 1, off, cudaGraphCondTypeIf, &branches[1]);
      if (b.err == cudaSuccess) {
        b.child(vbody, nullptr, static_cast<cudaGraph_t>(verify));
        b.child(pbody, nullptr, static_cast<cudaGraph_t>(plain));
      }
      if (b.err == cudaSuccess) {
        // a join point for the two branches
        cudaGraphNode_t join = nullptr;
        b.ok(cudaGraphAddEmptyNode(&join, body, branches, 2));
        last = join;
      }
    } else {
      last = b.child(body, last, static_cast<cudaGraph_t>(plain));
    }
    if (post && b.err == cudaSuccess) last = b.child(body, last, static_cast<cudaGraph_t>(post));
    void* again_args[] = {&loop, &cont_p};
    if (b.err == cudaSuccess) {
      b.kernel(body, &last, 1, reinterpret_cast<void*>(set_loop), again_args);
    }
  }
  if (tail && b.err == cudaSuccess) b.child(g, wnode, static_cast<cudaGraph_t>(tail));
  cudaGraphExec_t exec = nullptr;
  if (b.err == cudaSuccess) b.ok(cudaGraphInstantiate(&exec, g, 0));
  if (b.err != cudaSuccess) {
    cudaGraphDestroy(g);
    return b.err;
  }
  *exec_out = exec;
  *graph_out = g;
  return 0;
}

int atpu_loop_launch(void* exec, void* stream) {
  return cudaGraphLaunch(static_cast<cudaGraphExec_t>(exec), static_cast<cudaStream_t>(stream));
}

int atpu_loop_destroy(void* exec, void* graph) {
  cudaError_t e = cudaSuccess;
  if (exec) e = cudaGraphExecDestroy(static_cast<cudaGraphExec_t>(exec));
  if (graph) {
    cudaError_t e2 = cudaGraphDestroy(static_cast<cudaGraph_t>(graph));
    if (e == cudaSuccess) e = e2;
  }
  return e;
}

const char* atpu_loop_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
