"""bthread — M:N tasklets, butex, correlation ids, timers and CUDA-event
completion waits (reference: src/bthread/)."""
from .butex import Butex, ETIMEDOUT, EWOULDBLOCK
from .scheduler import (TaskControl, Tasklet, start_urgent, start_background,
                        join, self_id, current_tasklet, in_worker,
                        yield_tasklet, local_set, local_get,
                        note_worker_blocked, note_worker_unblocked)
from .execution_queue import ExecutionQueue, TaskIterator, execution_queue_start
from .timer_thread import TimerThread, timer_add, timer_del
from .countdown import CountdownEvent
from .device_waiter import (DeviceEventDispatcher, device_wait,
                            device_on_ready)
from . import id as bthread_id
