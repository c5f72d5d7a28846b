"""Benchmark report writer — same schema/fields as the reference reports.

Mirrors the append-mode plain-text report of private-search.go:282-328
(settings / preprocessing cost / online cost / quality) so runs are directly
comparable line-for-line with the reference's private-search-report.txt.
"""

from __future__ import annotations

import dataclasses


@dataclasses.dataclass
class PrivateSearchReport:
    vector_num: int
    db_size_bytes: float
    top_k: int
    rounds: int
    parallel: int
    rtt_ms: float
    window_size: int
    storage_bytes: float
    prep_time_s: float
    offline_comm_per_batch_bytes: float
    maintain_time_per_q_s: float
    avg_compute_time_per_q_s: float
    online_comm_per_batch_bytes: float
    recall: float = -1.0  # -1 => no ground truth (private-search.go:263)
    # Client memory beyond the reference's storage model (pir.go:178-190):
    # this design keeps the PRF offset tables / slot columns resident to skip
    # online AES, which the reference recomputes instead (pir.go:404-427).
    # Reported explicitly so storage comparisons are honest.
    extra_storage_bytes: float = 0.0

    @property
    def avg_total_time_per_q_s(self) -> float:
        """Compute + analytic RTT per round (private-search.go:320)."""
        return self.avg_compute_time_per_q_s + self.rtt_ms / 1000.0 * self.rounds

    def render(self) -> str:
        sp = self.rounds * self.parallel
        lines = [
            "-------------------------",
            "Private ANN Benchmarking w/ GPU Frontend",
            "Settings:",
            f"** Vector Num: {self.vector_num}",
            f"** DB Size (MB): {self.db_size_bytes / 1024.0 / 1024.0:f}",
            f"** Top K: {self.top_k}",
            f"** Rounds: {self.rounds}",
            f"** Parallel Exploration: {self.parallel}",
            f"** RTT (ms): {self.rtt_ms:g}",
            f"** Window Size: {self.window_size}",
            "",
            "Preprocessing Cost:",
            f"** Storage (MB): {self.storage_bytes / 1024.0 / 1024.0:f}",
            "** Extra Client State (MB, PRF tables): "
            f"{self.extra_storage_bytes / 1024.0 / 1024.0:f}",
            f"** Preparation Time (s): {self.prep_time_s:f}",
            "** Offline Communication Cost Per Q (KB, amt.): "
            f"{self.offline_comm_per_batch_bytes * sp / 1024.0:f}",
            f"** Amortized Maintainence Time Per Q (s): {self.maintain_time_per_q_s:f}",
            "",
            "Online Cost:",
            f"** Average Computation Time Per Query (s): {self.avg_compute_time_per_q_s:f}",
            f"** Average Total Time Per Q (s): {self.avg_total_time_per_q_s:f}",
            "** Online Communication Per Q (KB): "
            f"{self.online_comm_per_batch_bytes * sp / 1024.0:f}",
            "",
            "Quality:",
            f"** Recall: {self.recall:f}",
            "-----------------------",
        ]
        return "\n".join(lines) + "\n"

    def append_to(self, path: str) -> None:
        with open(path, "a") as f:
            f.write(self.render())
