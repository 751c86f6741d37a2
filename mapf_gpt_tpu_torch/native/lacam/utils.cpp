// Deadline + persistent thread pool (ref analogue: lacam3/src/utils.cpp; the
// pool replaces the reference's per-call std::thread / std::async spawns).
#include "lacam.hpp"

namespace lacam {

Deadline::Deadline(double s)
    : limit_s(s), start(std::chrono::steady_clock::now()) {}
bool Deadline::over() const { return elapsed_s() >= limit_s; }
double Deadline::elapsed_s() const {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() -
                                       start)
      .count();
}

ThreadPool::ThreadPool(int n_threads) {
  for (int i = 0; i < n_threads; i++) {
    workers_.emplace_back([this] {
      for (;;) {
        std::function<void()> task;
        {
          std::unique_lock<std::mutex> lk(mu_);
          cv_.wait(lk, [this] { return stop_ || !tasks_.empty(); });
          if (stop_ && tasks_.empty()) return;
          task = std::move(tasks_.front());
          tasks_.pop();
          active_++;
        }
        task();
        {
          std::lock_guard<std::mutex> lk(mu_);
          active_--;
          if (tasks_.empty() && active_ == 0) done_cv_.notify_all();
        }
      }
    });
  }
}

ThreadPool::~ThreadPool() {
  {
    std::lock_guard<std::mutex> lk(mu_);
    stop_ = true;
  }
  cv_.notify_all();
  for (auto& w : workers_) w.join();
}

void ThreadPool::submit(std::function<void()> fn) {
  {
    std::lock_guard<std::mutex> lk(mu_);
    tasks_.push(std::move(fn));
  }
  cv_.notify_one();
}

void ThreadPool::wait_all() {
  std::unique_lock<std::mutex> lk(mu_);
  done_cv_.wait(lk, [this] { return tasks_.empty() && active_ == 0; });
}

}  // namespace lacam
