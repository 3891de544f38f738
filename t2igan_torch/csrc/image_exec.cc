// Async data executor of the port: file read -> JPEG/PNG decode -> bbox
// crop -> scale/crop/flip -> multi-scale pyramid -> CLIP normalise, off the
// Python thread.
//
// A copy of the executor of t2igan/native/image_exec.cc (:155-390): a C++
// thread pool with a ring of pre-allocated batch slots.  Python submits a
// *plan* per batch (file paths, optional CUB bbox, crop fractions, flip
// bits); workers fill the slot's per-branch float32 buffers; Python blocks
// only on the oldest in-flight batch.  What differs: the decode is the
// port's own (image_decode.cc, PIL's pixels), and a sample that fails keeps
// its error message beside its code (t2i_exec_message), so that the caller
// can raise with the file and the fault; the JAX package sends such samples
// to PIL instead.
//
// Ownership protocol (mirrored by t2igan_torch/data/native.py::AsyncExecutor):
//   submit(batch) -> blocks only if all slots are in flight
//   wait()        -> blocks for the OLDEST submitted batch; returns its
//                    buffers, which stay valid until release(batch_id)
//   release(id)   -> recycles the slot

#include <atomic>
#include <condition_variable>
#include <deque>
#include <memory>
#include <mutex>
#include <string>
#include <thread>
#include <vector>

#include "image_core.h"
#include "image_decode.h"

namespace {

struct Slot {
  enum State { FREE, FILLING, DONE, OWNED };
  State state = FREE;
  int batch_id = -1;
  int n = 0;
  std::vector<std::string> paths;
  std::vector<int> bboxes;      // [n*4]; bboxes[4i+2] < 0 => no bbox
  std::vector<float> uv;        // [n*2] crop fractions in [0,1)
  std::vector<uint8_t> flips;   // [n]
  std::atomic<int> remaining{0};
  std::vector<int> sample_err;  // [n]
  std::vector<std::string> sample_msg;  // [n], the fault of a failed sample
  // Per-branch output: [max_batch * s * s * 3] float32, sample-major.
  std::vector<std::vector<float>> branch;
};

struct Exec {
  int n_branches;
  std::vector<int> branch_sizes;
  int scale_size, crop;
  float mean[3], stdv[3];
  int max_batch;

  std::vector<std::unique_ptr<Slot>> slots;
  std::deque<std::pair<int, int>> tasks;  // (slot index, sample index)
  std::deque<int> order;                  // FIFO of submitted slot indices
  std::mutex mu;
  std::condition_variable cv_task;  // workers wait for tasks
  std::condition_variable cv_done;  // wait() waits for oldest DONE
  std::condition_variable cv_free;  // submit() waits for a FREE slot
  std::vector<std::thread> workers;
  bool stop = false;

  void worker_loop();
  void process(Slot& s, int i);
};

void Exec::process(Slot& s, int i) {
  std::vector<uint8_t> rgb;
  int h = 0, w = 0;
  std::string msg;
  int err = t2i::load_rgb(s.paths[i], &s.bboxes[4 * i], rgb, &h, &w, &msg);
  if (err == t2i::T2I_OK) {
    int nh, nw;
    t2i::scaled_dims(h, w, scale_size, &nh, &nw);
    // floor(u * n) reproduces rng.integers(0, n) for uniform u in [0,1).
    const int rx = std::max(0, nw - crop), ry = std::max(0, nh - crop);
    const int x0 = std::min(rx, static_cast<int>(s.uv[2 * i] * (rx + 1)));
    const int y0 = std::min(ry, static_cast<int>(s.uv[2 * i + 1] * (ry + 1)));
    std::vector<float*> outs(n_branches);
    for (int b = 0; b < n_branches; ++b) {
      const size_t px = static_cast<size_t>(branch_sizes[b]) *
                        branch_sizes[b] * 3;
      outs[b] = s.branch[b].data() + static_cast<size_t>(i) * px;
    }
    if (t2i::pyramid_from_rgb(rgb.data(), h, w, scale_size, crop, x0, y0,
                              s.flips[i], branch_sizes.data(), n_branches,
                              outs.data(), mean, stdv)) {
      err = t2i::T2I_ERR_CROP;
      msg = s.paths[i] + ": crop window outside the scaled image";
    }
  }
  if (err != t2i::T2I_OK) {
    // zero-fill so consumers never read stale pixels from a recycled slot
    for (int b = 0; b < n_branches; ++b) {
      const size_t px = static_cast<size_t>(branch_sizes[b]) *
                        branch_sizes[b] * 3;
      std::memset(s.branch[b].data() + static_cast<size_t>(i) * px, 0,
                  px * sizeof(float));
    }
  }
  s.sample_err[i] = err;
  s.sample_msg[i] = msg;
  if (s.remaining.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lk(mu);
    s.state = Slot::DONE;
    cv_done.notify_all();
  }
}

void Exec::worker_loop() {
  for (;;) {
    std::pair<int, int> task;
    {
      std::unique_lock<std::mutex> lk(mu);
      cv_task.wait(lk, [&] { return stop || !tasks.empty(); });
      if (stop && tasks.empty()) return;
      task = tasks.front();
      tasks.pop_front();
    }
    process(*slots[task.first], task.second);
  }
}

}  // namespace

extern "C" {

void* t2i_exec_create(int n_threads, int n_slots, int max_batch,
                      const int* branch_sizes, int n_branches, int scale_size,
                      int crop, const float* mean, const float* stdv) {
  if (n_threads < 1 || n_slots < 1 || max_batch < 1 || n_branches < 1)
    return nullptr;
  Exec* e = new Exec();
  e->n_branches = n_branches;
  e->branch_sizes.assign(branch_sizes, branch_sizes + n_branches);
  e->scale_size = scale_size;
  e->crop = crop;
  std::memcpy(e->mean, mean, 3 * sizeof(float));
  std::memcpy(e->stdv, stdv, 3 * sizeof(float));
  e->max_batch = max_batch;
  e->slots.reserve(n_slots);
  for (int i = 0; i < n_slots; ++i) {
    auto s = std::make_unique<Slot>();
    s->branch.resize(n_branches);
    for (int b = 0; b < n_branches; ++b)
      s->branch[b].resize(static_cast<size_t>(max_batch) * branch_sizes[b] *
                          branch_sizes[b] * 3);
    e->slots.push_back(std::move(s));
  }
  for (int t = 0; t < n_threads; ++t)
    e->workers.emplace_back([e] { e->worker_loop(); });
  return e;
}

// Submit one batch plan.  paths: n C strings; bboxes: [n*4] (w<0 => none);
// uv: [n*2] crop fractions; flips: [n].  Blocks while all slots are in
// flight.  Returns 0, or -1 on invalid arguments.
int t2i_exec_submit(void* handle, int batch_id, int n, const char** paths,
                    const int* bboxes, const float* uv,
                    const uint8_t* flips) {
  Exec* e = static_cast<Exec*>(handle);
  if (!e || n < 1 || n > e->max_batch) return -1;
  int si;
  {
    std::unique_lock<std::mutex> lk(e->mu);
    e->cv_free.wait(lk, [&] {
      for (auto& s : e->slots)
        if (s->state == Slot::FREE) return true;
      return false;
    });
    si = -1;
    for (size_t i = 0; i < e->slots.size(); ++i)
      if (e->slots[i]->state == Slot::FREE) {
        si = static_cast<int>(i);
        break;
      }
    Slot& s = *e->slots[si];
    s.state = Slot::FILLING;
    s.batch_id = batch_id;
    s.n = n;
    s.paths.assign(paths, paths + n);
    s.bboxes.assign(bboxes, bboxes + 4 * n);
    s.uv.assign(uv, uv + 2 * n);
    s.flips.assign(flips, flips + n);
    s.sample_err.assign(n, t2i::T2I_OK);
    s.sample_msg.assign(n, std::string());
    s.remaining.store(n);
    e->order.push_back(si);
    for (int i = 0; i < n; ++i) e->tasks.emplace_back(si, i);
  }
  e->cv_task.notify_all();
  return 0;
}

// Number of batches submitted but not yet released.
int t2i_exec_inflight(void* handle) {
  Exec* e = static_cast<Exec*>(handle);
  std::lock_guard<std::mutex> lk(e->mu);
  int n = static_cast<int>(e->order.size());
  for (auto& s : e->slots)
    if (s->state == Slot::OWNED) ++n;
  return n;
}

// Block for the oldest in-flight batch.  Fills batch_id, n, per-branch
// buffer pointers (n_branches of them) and per-sample error codes
// (sample_err may be NULL).  The buffers stay valid until
// t2i_exec_release(batch_id).  Returns 0, or -1 if nothing is in flight.
int t2i_exec_wait(void* handle, int* batch_id, int* n, float** branch_ptrs,
                  int* sample_err) {
  Exec* e = static_cast<Exec*>(handle);
  int si;
  {
    std::unique_lock<std::mutex> lk(e->mu);
    if (e->order.empty()) return -1;
    si = e->order.front();
    e->cv_done.wait(lk, [&] { return e->slots[si]->state == Slot::DONE; });
    e->order.pop_front();
    e->slots[si]->state = Slot::OWNED;
  }
  Slot& s = *e->slots[si];
  *batch_id = s.batch_id;
  *n = s.n;
  for (int b = 0; b < e->n_branches; ++b) branch_ptrs[b] = s.branch[b].data();
  if (sample_err)
    std::memcpy(sample_err, s.sample_err.data(), s.n * sizeof(int));
  return 0;
}

// Recycle the slot owned via t2i_exec_wait.  Returns 0, -1 if unknown id.
int t2i_exec_release(void* handle, int batch_id) {
  Exec* e = static_cast<Exec*>(handle);
  {
    std::lock_guard<std::mutex> lk(e->mu);
    for (auto& s : e->slots)
      if (s->state == Slot::OWNED && s->batch_id == batch_id) {
        s->state = Slot::FREE;
        s->batch_id = -1;
        e->cv_free.notify_one();
        return 0;
      }
  }
  return -1;
}

// The message of sample `i` of the batch owned via t2i_exec_wait (empty
// when it succeeded).  Returns 0, or -1 for an unknown batch or sample.
int t2i_exec_message(void* handle, int batch_id, int i, char* buf,
                     int buflen) {
  Exec* e = static_cast<Exec*>(handle);
  std::lock_guard<std::mutex> lk(e->mu);
  for (auto& s : e->slots)
    if (s->state == Slot::OWNED && s->batch_id == batch_id) {
      if (i < 0 || i >= s->n) return -1;
      t2i::copy_message(s->sample_msg[i], buf, buflen);
      return 0;
    }
  return -1;
}

void t2i_exec_destroy(void* handle) {
  Exec* e = static_cast<Exec*>(handle);
  if (!e) return;
  {
    std::lock_guard<std::mutex> lk(e->mu);
    e->stop = true;
  }
  e->cv_task.notify_all();
  for (auto& t : e->workers) t.join();
  delete e;
}


}  // extern "C"
