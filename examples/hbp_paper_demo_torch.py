"""The paper in action, through the PyTorch port's simulator core
(``repro_torch.core``): run the simulated multicore and reproduce the
headline claims — PWS's deterministic priority-ordered steals, the <= p-1
steals-per-priority bound, and the block-miss (false sharing) advantage of
PWS + gapping over randomized work stealing.

  python examples/hbp_paper_demo_torch.py

It prints the same table as ``examples/hbp_paper_demo.py`` (the JAX
package's copy of the core), number for number.
"""
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.core.algorithms import (
    BItoRMDirect,
    MSum,
    bi_to_rm_gapped_programs,
    strassen_program,
)
from repro_torch.core.hbp import Memory
from repro_torch.core.machine import Machine
from repro_torch.core.pws import PWS
from repro_torch.core.rws import RWS

P, M, B = 8, 512, 16


def run(make, sched):
    machine = Machine(P, M, B, scheduler=sched)
    progs = make()
    st = (machine.run_sequence(progs) if isinstance(progs, list)
          else machine.run(progs))
    return st


print(f"simulated multicore: p={P} cores, M={M} words cache, B={B} block\n")

# 1. scans under PWS: priority-ordered steals, <= p-1 per priority
st = run(lambda: MSum(1 << 14, Memory(B)), PWS())
spp = st.steals_per_priority()
print("M-Sum (scan), n=16384 under PWS:")
print(f"  steals={len(st.steals)} max-per-priority={max(spp.values())} (bound p-1={P-1})")
print(f"  cache misses={st.total_cache_misses()} block misses={st.total_block_misses()}")

# 2. false sharing: direct BI->RM vs the gapping technique, PWS vs RWS
print("\nBI->RM conversion (64x64), block misses (false sharing):")
for name, make in [("direct", lambda: BItoRMDirect(64, Memory(B))),
                   ("gapped", lambda: bi_to_rm_gapped_programs(64, Memory(B)))]:
    pws_bm = run(make, PWS()).total_block_misses()
    rws_bm = sum(run(make, RWS(seed=s)).total_block_misses() for s in range(5)) / 5
    print(f"  {name:7s}: PWS={pws_bm:5.1f}   RWS(mean of 5)={rws_bm:5.1f}")

# 3. Type-2 HBP: Strassen with MA collections and 7-way recursion
st = run(lambda: strassen_program(16, Memory(B), base=4), PWS())
print(f"\nStrassen 16x16 (Type 2 HBP): accesses={st.accesses} "
      f"steals={len(st.steals)} usurpations={st.usurpations}")
print("done — see benchmarks/table1.py for the full Table 1 sweep")
