"""Stall watchdog: terminate-and-save when sensor data stops arriving.
(the port's own copy of gslivm_tpu/utils/watchdog.py; numpy on the host, as there)

Behavioral spec: the reference's single watchdog — a ROS timer
(`check_timer`, period 1000 s, lioOptimization.cpp:236) whose handler sets
`stop_thread = true` when GS has started but no sensor message arrived
since the previous tick (`heartHandler`, lioOptimization.cpp:760-765;
`is_received_data` set in imuHandler:768). This is how a finished rosbag
terminates the run and triggers saveRender.

ROS-free redesign: a plain object with `notify_data()` called from the
sensor push path, `notify_started()` when mapping begins, and either
periodic `check()` calls from the driver loop or a background-thread
`start()` (the ros::Timer analog). `on_stall` runs once, on the caller /
timer thread.
"""

from __future__ import annotations

import threading
from typing import Callable


class StallWatchdog:
    def __init__(self, period_s: float = 1000.0,
                 on_stall: Callable[[], None] | None = None):
        self.period_s = period_s
        self.on_stall = on_stall
        self._received = False
        self._started = False
        self.stopped = False
        self._timer: threading.Timer | None = None
        self._lock = threading.Lock()

    # --- signals (imuHandler:768 / is_gs_started) -------------------------

    def notify_data(self):
        self._received = True

    def notify_started(self):
        self._started = True

    # --- the heartHandler tick (lioOptimization.cpp:760-765) --------------

    def check(self) -> bool:
        """One watchdog tick; returns True once the run should stop."""
        with self._lock:
            if self._started and not self._received and not self.stopped:
                self.stopped = True
                if self.on_stall is not None:
                    self.on_stall()
            self._received = False
            return self.stopped

    # --- optional background timer (the ros::Timer analog) ----------------

    def start(self):
        def tick():
            if not self.check():
                self.start()

        self._timer = threading.Timer(self.period_s, tick)
        self._timer.daemon = True
        self._timer.start()

    def cancel(self):
        if self._timer is not None:
            self._timer.cancel()
            self._timer = None
