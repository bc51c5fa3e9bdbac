#!/bin/bash
# Mutation check of the kernels' checks in chip_smoke.py, on the card:
#
#     bash chip_mutants.sh        # from the repository root; needs one card
#     bash chip_mutants.sh k6_no_bias k7_next_heads_keys   # only these
#     MUTANT_JOBS=4 bash chip_mutants.sh ...   # four mutants' phases at once
#
# Each mutant is a copy of chip_smoke.py and sema_tpu_torch/ under
# build/mut-<name>/ with one fault put by sed into a CUDA source or a
# Python wrapper (or, where the fault spans both, into each); the phase
# that must catch it runs from the copy and must exit non-zero.
# A cli_mutant breaks K5 so that it cannot build or refuses its tensors,
# and `python -m sema_tpu_torch query` on the int8 encoder must then exit
# non-zero with the kernel's error, not answer from the substring scan;
# or it breaks K2's build, and the TUI (`python -m sema_tpu_torch DIR`
# under a pty) must exit non-zero with the kernel's error and never show
# "Indexing failed". The shard_* mutants break the store's row sharding
# (phase shard_path). The doctor_* mutants put the fault of a mutant above
# again and must fail the doctor's self-test (phase doctor_path). The
# tools_path mutants break a measuring tool or encoder_ablate's ablated
# builds; their phase runs only the tool at fault (--tools).
# Prints one line per mutant, "caught" or "MISSED" (once every mutant's
# phase has ended), and exits non-zero if any mutant was missed or left
# its source unchanged. MUTANT_JOBS phases run at once on the card
# (default 1). The kernels of the
# unchanged sources are built once and copied into each mutant's tree
# (a library's name carries its source's hash, so a mutated source is
# rebuilt there).
set -u
cd "$(dirname "$0")"
python3 -c 'from sema_tpu_torch.ops import _cuda; _cuda.build()' || exit 1
failed=0
JOBS=${MUTANT_JOBS:-1}
checked=()   # the mutants' directories, each with its verdict once checked
declare -A FILE EXPR FILE2 EXPR2   # each mutant's fault, by name
ONLY=("$@")
# true for every mutant when none is named on the command line
chosen() { [ ${#ONLY[@]} -eq 0 ] || [[ " ${ONLY[*]} " == *" $1 "* ]]; }
mutant() {
  # name, CUDA source (or a path under sema_tpu_torch/), sed expression,
  # phases[, a second file under sema_tpu_torch/ and its sed expression]
  local name=$1 file=$2 expr=$3 phases=$4 file2=${5:-} expr2=${6:-}
  FILE[$name]=$file EXPR[$name]=$expr FILE2[$name]=$file2 EXPR2[$name]=$expr2
  [[ $file == */* ]] || file=csrc/$file
  chosen "$name" || return 0
  local dir=build/mut-$name
  rm -rf "$dir"
  mkdir -p "$dir/build"
  cp -r chip_smoke.py sema_tpu_torch "$dir"/
  cp -r build/kernels "$dir/build/"
  sed -i "$expr" "$dir/sema_tpu_torch/$file"
  [ -z "$file2" ] || sed -i "$expr2" "$dir/sema_tpu_torch/$file2"
  if cmp -s "$dir/sema_tpu_torch/$file" "sema_tpu_torch/$file" || { [ -n "$file2" ] \
      && cmp -s "$dir/sema_tpu_torch/$file2" "sema_tpu_torch/$file2"; }; then
    echo "mutant $name: the fault did not apply"
    failed=1
    return
  fi
  check_mutant "$dir" "$name" "$phases" &
  checked+=("$dir")
  while [ "$(jobs -rp | wc -l)" -ge "$JOBS" ]; do wait -n; done
}
# the phases from the mutant's tree, which must fail; the verdict into
# $dir/verdict
check_mutant() {
  local dir=$1 name=$2 phases=$3
  local args
  read -ra args <<< "$phases"   # the phases, then any other arguments
  if (cd "$dir" && python3 chip_smoke.py --phases "${args[@]}" \
        > out.txt 2> err.txt); then
    echo "mutant $name: MISSED by phase $phases" > "$dir/verdict"
  else
    echo "mutant $name: caught, $(grep -o 'RuntimeError: .*' \
      "$dir/err.txt" | head -1 | cut -c15-200)" > "$dir/verdict"
  fi
}
# K4a/K4b: the row's scale never multiplies its i32 dot
mutant no_row_scale scan_topk.cu \
  's/__fmul_rn(__int2float_rn(acc\[t\]\[2 \* h + c\]), rs)/__int2float_rn(acc[t][2 * h + c])/' \
  scan_int8
# K4a/K4b on the tensor cores: the row's scale applied before the i32 sum
# is converted to f32 (the product rounded back to an integer)
mutant int8_scale_before_convert scan_topk.cu \
  's/v = __fmul_rn(__int2float_rn(acc\[t\]\[2 \* h + c\]), rs);/v = __int2float_rn(__float2int_rn(acc[t][2 * h + c] * rs));/' \
  scan_int8
# K4a/K4b: the first k-step (32 int8 values) of every slab never scored
mutant int8_k_step_dropped scan_topk.cu \
  's/      for (int kk = 0; kk < cn; kk += 16) {/      for (int kk = 16; kk < cn; kk += 16) {/' \
  scan_int8
# K4a/K4b: each query's B fragment read from the next query's row
mutant int8_next_query_b scan_topk.cu \
  's/ldmatrix_x2(bf, brow + (lane \& 7) \* qstr + kk);/ldmatrix_x2(bf, brow + ((lane + 1) \& 7) * qstr + kk);/; s/(np \* 16 + (lane \& 7) + ((lane >> 4) << 3))/(np * 16 + ((lane + 1) \& 7) + ((lane >> 4) << 3))/' \
  scan_int8
# K4a/K4b: no wait for the stage's cp.async copies before it is scored
# (scan_int8's late_copies: rows in mapped host memory, each copy late)
mutant int8_cp_async_no_wait scan_topk.cu \
  's|cp_async_wait<NS - 2>();  // stage g.s have; the next may still fly|;|' \
  scan_int8
# pass 2 (all six scans) and K4's merge_ranked: the row id left out of the
# order, so tied scores collide (the ties TIE and SPREAD_TIE)
mutant pass2_id_dropped scan_topk.cu \
  's/  return s1 > s2 || (s1 == s2 \&\& i1 < i2);/  return s1 > s2;/' scan_int8
# pass 2: warp 1's run of chunk lists never merged (K1's cases)
mutant pass2_run_dropped scan_topk.cu \
  's/  for (int c = c0; c < c1; ++c) {/  for (int c = c0; c < (warp == 1 ? c0 : c1); ++c) {/' \
  scan_topk
# pass 2: each run ends one chunk late, so a chunk's list merges twice
mutant pass2_run_boundary_off_by_one scan_topk.cu \
  's/  const int c1 = run_start(warp + 1, n_chunks, W);/  const int c1 = min(n_chunks, run_start(warp + 1, n_chunks, W) + 1);/' \
  scan_int8
# K3/K4b: the tile list is ignored, rows are read in order
mutant tiles_ignored scan_topk.cu 's/return a.tile_ids == nullptr ? t0/return true ? t0/' \
  scan_int8
# K2 (and K5-K7), S <= 512: probs @ V reads the first value tile over and
# over
mutant values_first_tile encoder_layer.cu \
  's/const int k0 = (i < nt ? i : i - nt) \* KT;/const int k0 = (i < nt ? i : 0) * KT;/' \
  encoder_layer
# K7, S > 512 (the three-pass kernel, at S = 640): probs @ V reads the first
# key block over and over
mutant long_rows_first_block encoder_layer.cu 's/load_keys(k0, true);/load_keys(0, true);/' \
  attention
# K7 (and K2, K5, K6) at S = 512: the second key tile is never scored
mutant attn_second_key_tile_skipped encoder_layer.cu \
  's|if (!active) continue;  // keys: no arithmetic past S|if (!active \|\| j == 1) continue;|' \
  attention
# K7 (and K2, K5, K6) past 256 keys: the scores of every key tile past the
# fourth are truncated to the compute dtype, not rounded to nearest (caught
# by rounding_probe)
mutant attn_late_scores_truncated encoder_layer.cu \
  's/const uint32_t pair = Ty<DT>::pack(sv\[2 \* h\], sv\[2 \* h + 1\]);/const uint32_t pair = j < 4 ? Ty<DT>::pack(sv[2 * h], sv[2 * h + 1]) : DT == DT_BF16 ? Ty<DT>::pack(__bfloat162float(__float2bfloat16_rz(sv[2 * h])), __bfloat162float(__float2bfloat16_rz(sv[2 * h + 1]))) : Ty<DT>::pack(__half2float(__float2half_rz(sv[2 * h])), __half2float(__float2half_rz(sv[2 * h + 1])));/' \
  attention
# K7 (and K2, K5, K6): the mask bias is dropped from every key tile but the
# first (keys past S then score as zeros)
mutant attn_mask_dropped_later_tiles encoder_layer.cu \
  's/const float2 bb = \*reinterpret_cast<const float2\*>(bias_j + t \* 8);/const float2 bb = j > 0 ? make_float2(0.f, 0.f) : *reinterpret_cast<const float2*>(bias_j + t * 8);/' \
  attention
# K6's wgmma GEMM: the consumers wait on the full barrier with the wrong
# phase parity, so a slab is read before (or long after) its bytes land
mutant wgmma_wrong_parity encoder_layer.cu \
  's|mbar_wait(full + s, ph);  // the slab.s bytes have landed|mbar_wait(full + s, ph ^ 1);|' \
  attention
# K6's wgmma GEMM: the last slab of K is never loaded nor multiplied
mutant wgmma_last_slab_dropped encoder_layer.cu \
  's|const int nk = (K + kWgBK - 1) / kWgBK;  // slabs of K|const int nk = (K + kWgBK - 1) / kWgBK - 1;|' \
  attention
# K6's wgmma GEMM: the epilogue drops the bias
mutant wgmma_no_bias encoder_layer.cu \
  's/Ty<DT>::pack(acc\[4 \* j + 2 \* h\] + bb.x, acc\[4 \* j + 2 \* h + 1\] + bb.y);/Ty<DT>::pack(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);/' \
  attention
# K2, f32: the padding mask is dropped
mutant f32_mask_dropped encoder_layer.cu \
  's/__fadd_rn(__fmul_rn(s\[i\]\[j\], scale), bj)/__fmul_rn(s[i][j], scale)/' \
  encoder_layer
# K2 (and K5-K7), f32: every key and value tile is the next one (past S,
# zeros), caught by K2's check and, separately, by K6's and K7's
mutant f32_kv_next_tile encoder_layer.cu \
  's/const int k0 = t \* kF32Keys;/const int k0 = (t + 1) * kF32Keys;/' \
  encoder_layer
mutant f32_kv_next_tile_k67 encoder_layer.cu \
  's/const int k0 = t \* kF32Keys;/const int k0 = (t + 1) * kF32Keys;/' \
  attention
# K2, f16: the products read the f16 operands as bf16
mutant f16_as_bf16 encoder_layer.cu 's/f32.f16.f16.f32/f32.bf16.bf16.f32/' \
  encoder_layer
# K2, head dim 64 at rows of 32 keys (gte-large's shortest bucket only):
# half of each head's context is never written
mutant hd64_short_half_context encoder_layer.cu \
  's|constexpr int NO = HD / 8;   // n8 tiles of context|constexpr int NO = (HD == 64 \&\& KT <= 32) ? 4 : HD / 8;|' \
  encoder_layer
# K2, f16: every result rounds to bf16's precision before it is stored
mutant f16_rounded_as_bf16 encoder_layer.cu \
  's/return __float2half_rn(x); }/return __float2half_rn(__bfloat162float(__float2bfloat16_rn(x))); }/; s/__half2 v = __floats2half2_rn(lo, hi);/__half2 v = __floats2half2_rn(__bfloat162float(__float2bfloat16_rn(lo)), __bfloat162float(__float2bfloat16_rn(hi)));/' \
  encoder_layer
# K5: activations rounded toward zero, not half to even
mutant k5_round_toward_zero encoder_layer.cu \
  's/__float2int_rn(__fdiv_rn(v, sx))/__float2int_rz(__fdiv_rn(v, sx))/' \
  encoder_layer_int8
# K5: the activation scale taken by output column, not by row
mutant k5_scale_by_column encoder_layer.cu 's/sa\[row\]/sa[col % M]/g' \
  encoder_layer_int8
# K5: the weight scale dropped from the rescale
mutant k5_no_weight_scale encoder_layer.cu \
  's/return __fmul_rn(__fmul_rn(__int2float_rn(acc), sx), ws);/return __fmul_rn(__int2float_rn(acc), sx);/' \
  encoder_layer_int8
# K5 at S = 512: probs @ V reads the first value tile over and over
mutant k5_values_first_tile encoder_layer.cu \
  's/const int k0 = (i < nt ? i : i - nt) \* KT;/const int k0 = (i < nt ? i : 0) * KT;/' \
  encoder_layer_int8
# K6: the qkv GEMM's epilogue drops the bias (K2's qkv GEMM shares it)
mutant k6_no_bias encoder_layer.cu \
  's/store2<DT>(out + (size_t)row \* N + col, v0 + b0, v1 + b1);/store2<DT>(out + (size_t)row * N + col, v0, v1);/' \
  attention
# K6 keeps K2's qkv layout: a scratch of x's width (3 H) that the attention
# steps through 3 H a row, where the GEMM writes its 3 H_out columns
# densely; every read stays inside the scratch and the head dim stays right
mutant k6_stride_of_x encoder_layer.cu \
  's/return attention_any<DT>(qkv, mask_bias, ctx, B, S, H_out, 3 \* H_out, num_heads, scale,/return attention_any<DT>(qkv, mask_bias, ctx, B, S, H_out, 3 * H, num_heads, scale,/' \
  attention ops/attention.py \
  's/qkv = torch.empty((b \* s, h3), dtype=dt, device=x.device)/qkv = torch.empty((b * s, 3 * h), dtype=dt, device=x.device)/'
# K7 (and K2) at S <= 512: each head scores against the next head's keys
mutant k7_next_heads_keys encoder_layer.cu \
  's|(i < nt ? H : 2 \* H)|(i < nt ? H + ((head + 1) % (H / HD) - head) * HD : 2 * H)|' \
  attention
# K1 (bf16/f16 pass 1 on the tensor cores): the first k-step of every slab
# is never scored, caught by K1's check and, separately, by the A/B path's
mutant mma_k_step_dropped scan_topk.cu \
  's/      for (int kk = 0; kk < cn; kk += 16) {/      for (int kk = 16; kk < cn; kk += 16) {/' \
  scan_topk
mutant mma_k_step_dropped_ab scan_topk.cu \
  's/      for (int kk = 0; kk < cn; kk += 16) {/      for (int kk = 16; kk < cn; kk += 16) {/' \
  scan_ab
# K1: no wait for the stage's cp.async copies before it is scored
mutant cp_async_no_wait scan_topk.cu \
  's|cp_async_wait_all();  // this thread.s copies of stage g have landed|;|' \
  scan_topk
# K8: the threshold is the sample's k-th itself, without the one-ULP backoff
mutant k8_no_backoff ops/scan_topk.py \
  's/    return torch.nextafter(sample_kth, sample_kth.new_tensor(float("-inf")))/    return sample_kth/' \
  scan_ab
# K8: each query screens with the next query's threshold
mutant k8_next_query_thr0 scan_topk.cu \
  's/a.thr0\[q0 + qi\]/a.thr0[q0 + (qi + 1) % nqb]/' scan_ab
# K9: the fast path whatever the lanes' survivor counts
mutant k9_always_fast scan_topk.cu \
  's/const bool fast = __all_sync(0xffffffffu, cnt <= 1);/const bool fast = true;/' \
  scan_ab
# K9: the highest column first among equal folded values
mutant k9_highest_column scan_topk.cu \
  's/(ov == bv \&\& oc < bc)/(ov == bv \&\& oc > bc)/' scan_ab
# K2 and K5, the LayerNorm GEMMs: no cluster barrier before the LayerNorm,
# so a block may read a peer's slice before the peer has written it
mutant ln_no_cluster_barrier encoder_layer.cu \
  's|  cluster.sync();  // every slice of the cluster is written||' encoder_layer
mutant ln_no_cluster_barrier_int8 encoder_layer.cu \
  's|  cluster.sync();  // every slice of the cluster is written||' \
  encoder_layer_int8
# K2 and K5: each block reads its own slice of a row c times over, not its
# peers' slices in column order
mutant ln_own_slice encoder_layer.cu \
  's/cluster.map_shared_rank(slice, p)/cluster.map_shared_rank(slice, rank)/' \
  encoder_layer
mutant ln_own_slice_int8 encoder_layer.cu \
  's/cluster.map_shared_rank(slice, p)/cluster.map_shared_rank(slice, rank)/' \
  encoder_layer_int8
# K2 and K5 (and K6's and qmm's GEMMs): the ring waits one stage short, so
# a slab is read before its copies land
mutant ring_wait_short encoder_layer.cu \
  's/cp_async_wait<STAGES - 2>();/cp_async_wait<STAGES - 1>();/g' encoder_layer
mutant ring_wait_short_int8 encoder_layer.cu \
  's/cp_async_wait<STAGES - 2>();/cp_async_wait<STAGES - 1>();/g' \
  encoder_layer_int8
# HBM spill, the union probe: every cluster's span in the union view one
# spill tile late, so that a probe stages the wrong tiles
mutant spill_union_offset_tile index/vector_store.py \
  's/            starts.append(np.asarray(iv\["starts"\]\[:c\], np.int64) + v)/            starts.append(np.asarray(iv["starts"][:c], np.int64) + v + t)/' \
  spill_path
# the union probe: a stage's rowmap without its bucket's row offset
mutant spill_rowmap_no_offset index/vector_store.py \
  's/            rowmap\[s0:s1\] = np.clip(rm, 0, rows - 1) + b\["row_offset"\]/            rowmap[s0:s1] = np.clip(rm, 0, rows - 1)/' \
  spill_path
# the streamed scan and the probe: one pinned host buffer per shape, filled
# again while the copy of the rows it held may still be on its way
mutant spill_pinned_reused index/vector_store.py \
  's/        return torch.empty(shape, dtype=dtype,/        return self.__dict__.setdefault((tuple(shape), dtype), torch.empty(shape, dtype=dtype,/; s/                           pin_memory=self.device.type == "cuda")/                           pin_memory=self.device.type == "cuda"))/' \
  spill_path
# the routing: a spilled bucket streams where the union probe served it,
# and not where it did not
mutant spill_stream_served index/vector_store.py \
  's/                if id(b) not in served:/                if id(b) in served:/' \
  spill_path
# the device append: the new rows written one row early, over the tail's
# last live row
mutant append_row0_minus_one index/vector_store.py \
  's/            b\["arena"\]\[row0:row1\].copy_(vals)/            b["arena"][row0 - 1:row1 - 1].copy_(vals)/' \
  append_path
# the device append: the new rows' flags never written, so they stay
# invalid
mutant append_mask_unwritten index/vector_store.py \
  's/        b\["arena_valid"\]\[row0:row1\].copy_(mask)/        pass/' \
  append_path
# the device rows read but never dropped, by the append or the build
mutant append_pending_kept index/vector_store.py \
  's/        pend = \[self._pending_dev.pop(s.name, None) for s in segs\]/        pend = [self._pending_dev.get(s.name) for s in segs]/; s/^        self._pending_dev.clear()$/        pass/' \
  append_path
# an append of several segments writes each one's device rows into
# another's range
mutant append_pendings_swapped index/vector_store.py \
  's/            vals = pend\[0\] if len(pend) == 1 else torch.cat(pend)/            vals = pend[0] if len(pend) == 1 else torch.cat(pend[::-1])/' \
  append_path
# the sharded scan: a shard's local ids never offset by its first row
mutant shard_offset_dropped parallel/sharded_topk.py \
  's/        ids.append(ix + s \* shard_rows)/        ids.append(ix)/' \
  shard_path
# the merge: equal scores ranked by the later shard first (the candidates
# gathered in reverse shard order)
mutant shard_merge_unstable parallel/sharded_topk.py \
  's/    s = torch.cat(\[t.to(device) for t in scores\], 1)/    s = torch.cat([t.to(device) for t in scores[::-1]], 1)/; s/    i = torch.cat(\[t.to(device) for t in ids\], 1)/    i = torch.cat([t.to(device) for t in ids[::-1]], 1)/' \
  shard_path
# per-shard IVF: a shard's cluster permutation without its block's offset
mutant shard_ivf_perm_local index/vector_store.py \
  's/            perm\[s \* sr:(s + 1) \* sr\] = p + s \* sr/            perm[s * sr:(s + 1) * sr] = p/' \
  shard_path
# tools_path's: an ablated build of encoder_ablate that ignores its -D
# (prod and the ablated variants equal)
mutant ablate_define_ignored encoder_layer.cu \
  's/^#if SEMA_ABLATE == [12]$/#if 0/; s/^#elif SEMA_ABLATE == 2$/#elif 0/' \
  "tools_path --tools encoder_ablate"
# a tool that resolves its device to the CPU (no launch, device "cpu")
mutant tool_on_cpu tools/serving_sweep.py \
  's/dev = resolve_device(args.device)/dev = resolve_device("cpu")/' \
  "tools_path --tools serving_sweep"
# load_test's mutator streams into planted.txt, whose rows it then
# tombstones (mismatches > 0)
mutant load_test_mutates_planted tools/load_test.py \
  's/return f"stream-{gen}.txt"/return "planted.txt"/' \
  "tools_path --tools load_test"
# the product's build of encoder_layer.cu takes the no_exp softmax: K2
# against its plain version must fail
mutant product_build_ablated encoder_layer.cu \
  's/^#define SEMA_ABLATE 0$/#define SEMA_ABLATE 1/' encoder_layer
# the doctor's self-test (planted winners at k = 1, the encoder against f32
# on the CPU) against the faults of kernels it launches: K1, K3, K4a, K2,
# K5 and the spilled union probe
for m in pass2_id_dropped tiles_ignored no_row_scale values_first_tile \
    k5_no_weight_scale spill_rowmap_no_offset; do
  mutant "doctor_$m" "${FILE[$m]}" "${EXPR[$m]}" doctor_path "${FILE2[$m]}" \
    "${EXPR2[$m]}"
done
wait
for dir in "${checked[@]}"; do
  cat "$dir/verdict"
  ! grep -q MISSED "$dir/verdict" || failed=1
done
# argv through a pty (curses needs a terminal): the child's output to
# stdout, its exit code as ours, 124 if it has not exited in 300 s
PTY_RUN='
import os, pty, select, sys, time
pid, fd = pty.fork()
if pid == 0:
    try:
        os.execvp(sys.executable, [sys.executable] + sys.argv[1:])
    finally:
        os._exit(127)
out, end, status = b"", time.monotonic() + 300, None
while status is None and time.monotonic() < end:
    if select.select([fd], [], [], 0.1)[0]:
        try:
            out += os.read(fd, 65536)
        except OSError:
            pass
    done, code = os.waitpid(pid, os.WNOHANG)
    status = code if done else None
if status is None:
    os.kill(pid, 9)
    os.waitpid(pid, 0)
sys.stdout.write(out.decode(errors="replace"))
sys.exit(124 if status is None else os.waitstatus_to_exitcode(status))
'
cli_mutant() {
  # name, a file under sema_tpu_torch/, sed expression, the error expected,
  # and the command: query (the int8 encoder's) or tui
  local name=$1 file=$2 expr=$3 expect=$4 how=${5:-query}
  chosen "$name" || return 0
  local dir=build/mut-$name
  rm -rf "$dir"
  mkdir -p "$dir/build"
  cp -r chip_smoke.py sema_tpu_torch "$dir"/
  cp -r build/kernels "$dir/build/"
  sed -i "$expr" "$dir/sema_tpu_torch/$file"
  if cmp -s "$dir/sema_tpu_torch/$file" "sema_tpu_torch/$file"; then
    echo "mutant $name: the fault did not apply"
    failed=1
    return
  fi
  local cmd=(env SEMA_TPU_ENCODER_QUANT=int8 python3 -m sema_tpu_torch query
             "retry with exponential backoff") bad=substring
  if [ "$how" = tui ]; then
    mkdir -p "$dir/tree"
    printf 'def retry(request):\n    return request.send()  # backoff\n' \
      > "$dir/tree/net.py"
    cmd=(env TERM=xterm-256color COLUMNS=100 LINES=30 python3 -c "$PTY_RUN"
         -m sema_tpu_torch tree)
    bad="Indexing failed"
  fi
  if (cd "$dir" && SEMA_TPU_HOME="$PWD/home" SEMA_TPU_DATA="$PWD/data" \
        "${cmd[@]}" > out.txt 2> err.txt); then
    echo "mutant $name: MISSED, $how exited 0"
    failed=1
  elif cat "$dir/out.txt" >> "$dir/err.txt"; grep -q "$bad" "$dir/err.txt" \
      || ! grep -q "$expect" "$dir/err.txt"; then
    echo "mutant $name: MISSED, $(tail -c 300 "$dir/err.txt")"
    failed=1
  else
    echo "mutant $name: caught, $how exited non-zero:" \
      "$(grep -o 'Error: .*' "$dir/err.txt" | head -1 | cut -c1-160)"
  fi
}
# K5's library does not build
cli_mutant k5_build_fails csrc/encoder_layer.cu \
  's/^extern "C" int sema_qmm/#error a build that fails\nextern "C" int sema_qmm/' \
  "kernel build failed"
# K5's wrapper refuses the tensors it is given
cli_mutant k5_refuses ops/encoder_layer_int8.py \
  's/        _check(x, layer, mask_bias, num_heads, quantized=True)/        raise KernelError("refused by the mutant")/; s/        _check_operands(x, mask_bias, num_heads, operands, True)/        raise KernelError("refused by the mutant")/' \
  "refused by the mutant"
# K2's library does not build: the TUI's startup index must end it
cli_mutant tui_k2_build_fails csrc/encoder_layer.cu \
  's/^extern "C" int sema_encoder_layer(/#error a build that fails\nextern "C" int sema_encoder_layer(/' \
  "kernel build failed" tui
exit $failed
