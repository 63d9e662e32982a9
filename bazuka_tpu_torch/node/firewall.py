"""Per-IP rate/traffic limiter (reference: src/node/firewall.rs).
A copy of `bazuka_tpu/node/firewall.py`."""

from __future__ import annotations

from typing import Dict


class Firewall:
    def __init__(self, request_count_limit_per_minute: int = 60,
                 traffic_limit_per_minute: int = 16 * 1024 * 1024):
        self.request_count_limit_per_minute = request_count_limit_per_minute
        self.traffic_limit_per_minute = traffic_limit_per_minute
        self.request_count_last_reset = 0
        self.request_count: Dict[str, int] = {}
        self.traffic_last_reset = 0
        self.traffic: Dict[str, int] = {}

    def refresh(self, now: int):
        if now - self.request_count_last_reset > 60:
            self.request_count.clear()
            self.request_count_last_reset = now
        if now - self.traffic_last_reset > 60:
            self.traffic.clear()
            self.traffic_last_reset = now

    def add_traffic(self, ip: str, amount: int):
        self.traffic[ip] = self.traffic.get(ip, 0) + amount

    def incoming_permitted(self, ip: str) -> bool:
        if ip in ("127.0.0.1", "::1", "localhost", None):
            return True
        if self.traffic.get(ip, 0) > self.traffic_limit_per_minute:
            return False
        cnt = self.request_count.get(ip, 0)
        if cnt >= self.request_count_limit_per_minute:
            return False
        self.request_count[ip] = cnt + 1
        return True
