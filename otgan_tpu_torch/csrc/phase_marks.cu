// Phase marks: the device half of ``utils/tracing.py::phase``.
//
// Replaces no TPU kernel. The JAX package names its steps and phases for the
// XLA profiler, which keeps the names inside a compiled cycle. A CUDA graph
// keeps no host span: a replay of a captured G:D cycle is one host call. So
// each boundary of a step or of one of its phases is a kernel of its own,
// launched on the step's stream, recorded into the graph at capture and run
// in every replay, as in every eager step.
//
// A mark is one thread. It reads the card's nanosecond clock (%globaltimer,
// the clock of the profiler's device timeline). A begin mark stores it in
// its slot; the matching end mark adds the time since to the slot's total and
// one to its count. Stream order puts every kernel of the phase between the
// two. Slots nest: a step's slot runs from its first mark to its last and
// holds its phases; ``refeatures`` (each microbatch's forward under autograd
// under ``--grad_accum``) lies inside ``loss_backward``. Each (kind, slot,
// edge) is its own instantiation, so a profiler trace names every boundary,
// e.g. ``otgan_mark<disc, match, begin>``.
//
// Bound: launch latency alone (one thread, one store or two read-modify-
// writes of 8 bytes), ~1-2 us a mark in a graph; ten marks a step, two more
// a microbatch under ``--grad_accum``.
//
// Slots: unsigned long long [2 kinds][6 slots][3] = {begin ns, total ns,
// count}; kinds gen, disc; slots features, match, loss_backward, update, step,
// refeatures (``tracing.KINDS``, ``tracing.SLOTS``).

#include <cuda_runtime.h>

struct gen {};
struct disc {};
struct features {};
struct match {};
struct loss_backward {};
struct update {};
struct step {};
struct refeatures {};
struct begin {};
struct end {};

template <class T> struct index_of;
template <> struct index_of<gen> { static constexpr int value = 0; };
template <> struct index_of<disc> { static constexpr int value = 1; };
template <> struct index_of<features> { static constexpr int value = 0; };
template <> struct index_of<match> { static constexpr int value = 1; };
template <> struct index_of<loss_backward> { static constexpr int value = 2; };
template <> struct index_of<update> { static constexpr int value = 3; };
template <> struct index_of<step> { static constexpr int value = 4; };
template <> struct index_of<refeatures> { static constexpr int value = 5; };
template <> struct index_of<begin> { static constexpr int value = 0; };
template <> struct index_of<end> { static constexpr int value = 1; };

constexpr int KINDS = 2;
constexpr int SLOTS = 6;

template <class K, class P, class E>
__global__ void otgan_mark(unsigned long long* slots) {
  unsigned long long now;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
  unsigned long long* s = slots + 3 * (index_of<K>::value * SLOTS + index_of<P>::value);
  if (index_of<E>::value == 0) {
    s[0] = now;
  } else {
    s[1] += now - s[0];
    s[2] += 1;
  }
}

typedef void (*mark_fn)(unsigned long long*);

#define OTGAN_EDGES(K, P) {otgan_mark<K, P, begin>, otgan_mark<K, P, end>}
#define OTGAN_SLOTS(K)                                                              \
  {OTGAN_EDGES(K, features), OTGAN_EDGES(K, match), OTGAN_EDGES(K, loss_backward), \
   OTGAN_EDGES(K, update), OTGAN_EDGES(K, step), OTGAN_EDGES(K, refeatures)}

static const mark_fn MARKS[KINDS][SLOTS][2] = {OTGAN_SLOTS(gen), OTGAN_SLOTS(disc)};

// One mark on ``stream``: ``edge`` 0 begins the slot (kind, slot), 1 ends it.
// Returns the launch's CUDA error (0 on success).
extern "C" int otgan_phase_mark(int kind, int slot, int edge, void* slots, void* stream) {
  if (kind < 0 || kind >= KINDS || slot < 0 || slot >= SLOTS || edge < 0 || edge > 1) {
    return cudaErrorInvalidValue;
  }
  unsigned long long* arg = static_cast<unsigned long long*>(slots);
  void* args[] = {&arg};
  return cudaLaunchKernel(reinterpret_cast<const void*>(MARKS[kind][slot][edge]), dim3(1),
                          dim3(1), args, 0, static_cast<cudaStream_t>(stream));
}

extern "C" const char* otgan_phase_mark_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
