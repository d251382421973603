// Timed condition-variable waits, routed for ThreadSanitizer builds.
//
// libstdc++ (glibc >= 2.30) implements wait_for / steady-clock
// wait_until via pthread_cond_clockwait, which this image's libtsan
// (GCC 10) has NO interceptor for: TSan never sees the mutex release
// inside the wait and reports a bogus "double lock of a mutex" when
// the waker takes it.  Under -fsanitize=thread these helpers go
// through a system_clock wait_until instead, which lowers to
// pthread_cond_timedwait (intercepted); production builds keep the
// steady clock (immune to wall-clock jumps).  This is a TOOLCHAIN
// interception gap, not a suppression of a real finding — the locking
// under test is identical either way.
#pragma once

#include <chrono>
#include <condition_variable>
#include <mutex>

namespace nbase {

#if defined(__SANITIZE_THREAD__)

template <class Rep, class Period, class Pred>
inline bool cv_wait_for(std::condition_variable& cv,
                        std::unique_lock<std::mutex>& lk,
                        std::chrono::duration<Rep, Period> d, Pred pred) {
  return cv.wait_until(lk, std::chrono::system_clock::now() + d, pred);
}

template <class Rep, class Period>
inline std::cv_status cv_wait_for(std::condition_variable& cv,
                                  std::unique_lock<std::mutex>& lk,
                                  std::chrono::duration<Rep, Period> d) {
  return cv.wait_until(lk, std::chrono::system_clock::now() + d);
}

template <class Clock, class Duration>
inline std::cv_status cv_wait_until(
    std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
    std::chrono::time_point<Clock, Duration> tp) {
  auto left = tp - Clock::now();
  if (left < left.zero()) left = left.zero();
  return cv.wait_until(
      lk, std::chrono::system_clock::now() +
              std::chrono::duration_cast<std::chrono::microseconds>(left));
}

#else

template <class Rep, class Period, class Pred>
inline bool cv_wait_for(std::condition_variable& cv,
                        std::unique_lock<std::mutex>& lk,
                        std::chrono::duration<Rep, Period> d, Pred pred) {
  return cv.wait_for(lk, d, pred);
}

template <class Rep, class Period>
inline std::cv_status cv_wait_for(std::condition_variable& cv,
                                  std::unique_lock<std::mutex>& lk,
                                  std::chrono::duration<Rep, Period> d) {
  return cv.wait_for(lk, d);
}

template <class Clock, class Duration>
inline std::cv_status cv_wait_until(
    std::condition_variable& cv, std::unique_lock<std::mutex>& lk,
    std::chrono::time_point<Clock, Duration> tp) {
  return cv.wait_until(lk, tp);
}

#endif

}  // namespace nbase
