/* fastk_native — host-side hot loops for the TPU k-mer framework.
 *
 * Native equivalents of the reference's C ingest path (io.c:574-759 FASTA/
 * FASTQ scanners; homopolymer compression io.c:284-294; 2-bit packing
 * split.c:864-989), exposed through ctypes. The TPU framework keeps its
 * Python implementations as fallbacks; this library exists because sequence
 * parsing is the one per-byte loop that must run at memory speed on the
 * host before data ever reaches the chip.
 *
 * Build: cc -O2 -shared -fPIC -o fastk_native.so fastk_native.c
 */

#include <stdint.h>
#include <stdlib.h>
#include <string.h>

/* base codes: acgt/ACGT -> 0..3, everything else -> 4 (invalid) */
static uint8_t CODE[256];
static int code_init = 0;

static void init_code(void)
{ int i;
  if (code_init) return;
  for (i = 0; i < 256; i++) CODE[i] = 4;
  CODE['a'] = CODE['A'] = 0;
  CODE['c'] = CODE['C'] = 1;
  CODE['g'] = CODE['G'] = 2;
  CODE['t'] = CODE['T'] = 3;
  code_init = 1;
}

/* Scan a FASTA or FASTQ buffer into a code stream.
 *
 * buf[n]:    whole file contents (uncompressed)
 * fastq:     0 = FASTA, 1 = FASTQ
 * hc:        homopolymer-compress (case-SENSITIVE on raw bytes, like the
 *            reference's ADD macro)
 * bc:        drop this many leading bases of each read (after hc)
 * codes:     out, capacity ccap; reads separated by one sentinel (4);
 *            stream does NOT begin with a sentinel; every read
 *            (including the last) is FOLLOWED by one sentinel
 * boff:      out, capacity rcap+1; boff[r] = code offset of read r;
 *            boff[nreads] = total codes + 1 per read (sentinel slots)
 * rlen:      out, capacity rcap; emitted length of read r
 *
 * Returns number of reads, or -1 if codes overflow ccap, -2 if reads
 * overflow rcap, -3 on malformed input.
 */
long fk_scan_seq(const uint8_t *buf, long n, int fastq, int hc, int bc,
                 uint8_t *codes, long ccap,
                 int64_t *boff, int64_t *rlen, long rcap)
{ long i = 0, o = 0, r = 0;
  init_code();

  while (i < n)
    { /* header line */
      if (fastq)
        { if (buf[i] != '@') return -3;
        }
      else
        { if (buf[i] != '>') return -3;
        }
      while (i < n && buf[i] != '\n') i++;
      i++;                                   /* skip newline */

      if (r >= rcap) return -2;
      boff[r] = o;

      { long start = o;
        int  prev  = -1;                     /* raw byte, for hc */
        long kept  = 0;                      /* bases kept so far (for bc) */

        if (fastq)
          { /* exactly one sequence line */
            while (i < n && buf[i] != '\n')
              { int ch = buf[i++];
                if (ch == '\r') continue;
                if (hc && ch == prev) continue;
                prev = ch;
                if (kept++ < bc) continue;
                if (o >= ccap) return -1;
                codes[o++] = CODE[ch];
              }
            i++;                             /* newline */
            /* '+' line */
            while (i < n && buf[i] != '\n') i++;
            i++;
            /* quality line */
            while (i < n && buf[i] != '\n') i++;
            i++;
          }
        else
          { /* sequence lines until next '>' or EOF */
            while (i < n && buf[i] != '>')
              { int ch = buf[i++];
                if (ch == '\n' || ch == '\r') continue;
                if (hc && ch == prev) continue;
                prev = ch;
                if (kept++ < bc) continue;
                if (o >= ccap) return -1;
                codes[o++] = CODE[ch];
              }
          }

        rlen[r] = o - start;
        r++;
        if (o >= ccap) return -1;
        codes[o++] = 4;                      /* read separator */
      }
    }
  boff[r] = o;
  return r;
}

/* 2-bit pack a code stream: 4 codes/byte, position 0 in the low bits
 * (matching ops/pack.py pack_stream). Sentinels (>=4) pack as 0; their
 * positions are appended to exc (capacity ecap). n must be a multiple of 4
 * (pad with 0..3 codes of value 4 first). Returns the number of exceptions
 * or -1 on exc overflow. */
long fk_pack2(const uint8_t *codes, long n, uint8_t *packed,
              uint32_t *exc, long ecap)
{ long i, b, ne = 0;
  for (i = b = 0; i < n; i += 4, b++)
    { unsigned v = 0;
      int j;
      for (j = 0; j < 4; j++)
        { unsigned c = codes[i + j];
          if (c >= 4)
            { if (ne >= ecap) return -1;
              exc[ne++] = (uint32_t)(i + j);
              c = 0;
            }
          v |= c << (2 * j);
        }
      packed[b] = (uint8_t)v;
    }
  return ne;
}

/* Bulk-encode per-read profiles from a flat per-position counts array
 * (the .prof delta codec; writer analog of the reference's fragment
 * encoder count.c:868-947 / merge.c:394-733, over a whole batch in one
 * call instead of a Python loop per read).
 *
 * cnts:   per-position clipped counts (<= 0x7fff)
 * boff:   read r's counts start at cnts + boff[r]
 * plen:   profile length of read r (rlen - k + 1; <= 0 -> empty blob)
 * out:    concatenated encoded blobs (capacity ocap)
 * offs:   out, offs[r] = byte offset one past read r's blob
 *
 * Returns total bytes written, or -1 if out overflows. Byte-identical to
 * formats/prof.py:encode_profile (zero runs chunk greedily at 63 with the
 * remainder flushed at run end).
 */
long fk_prof_encode_bulk(const uint16_t *cnts, const int64_t *boff,
                         const int64_t *plen, long nreads,
                         uint8_t *out, long ocap, int64_t *offs)
{ long r, o = 0;
  for (r = 0; r < nreads; r++)
    { long n = plen[r];
      const uint16_t *c = cnts + boff[r];
      long i;
      unsigned prev;
      long zrun = 0;
      if (n > 0)
        { unsigned first = c[0] & 0x7fff;
          if (first < 128)
            { if (o >= ocap) return -1;
              out[o++] = (uint8_t)first;
            }
          else
            { if (o + 2 > ocap) return -1;
              out[o++] = (uint8_t)(0x80 | (first >> 8));
              out[o++] = (uint8_t)(first & 0xff);
            }
          prev = first;
          for (i = 1; i < n; i++)
            { unsigned cur = c[i] & 0x7fff;
              int d = (int)cur - (int)prev;
              if (d == 0)
                { if (++zrun == 63)
                    { if (o >= ocap) return -1;
                      out[o++] = 63;
                      zrun = 0;
                    }
                  continue;
                }
              if (zrun > 0)
                { if (o >= ocap) return -1;
                  out[o++] = (uint8_t)zrun;
                  zrun = 0;
                }
              if (d > -32 && d < 32)
                { if (o >= ocap) return -1;
                  out[o++] = (uint8_t)(0x40 | (d & 0x3f));
                }
              else
                { unsigned v = (unsigned)d & 0x7fff;
                  if (o + 2 > ocap) return -1;
                  out[o++] = (uint8_t)(0x80 | (v >> 8));
                  out[o++] = (uint8_t)(v & 0xff);
                }
              prev = cur;
            }
          if (zrun > 0)
            { if (o >= ocap) return -1;
              out[o++] = (uint8_t)zrun;
            }
        }
      offs[r] = o;
    }
  return o;
}

/* ------------------------------------------------------------------------
 * K-way sorted-stream union (the merge engine behind the streamed table
 * tools: logex/vennex window_union, fastmerge window_sum — the role of the
 * reference's equality-aware heap merges, Fastmerge.c:80-450 and
 * Logex.c:972-1215). Each stream is a contiguous (lens[i], kb) array of
 * kb-byte keys, sorted and unique within the stream. Writes the sorted
 * unique union to out_keys and, per stream, each input key's index in the
 * union to slots[i]. Returns the union size.
 *
 * ns is small (tool arguments), so a linear min-scan beats a heap: per
 * union entry the cost is <= 2*ns kb-byte compares.
 */
long fk_union_slots(int kb, int ns, const uint8_t **keys, const int64_t *lens,
                    uint8_t *out_keys, int64_t **slots)
{ int64_t cur[64];
  int     i, mi;
  long    U = 0;
  if (ns > 64) return -1;
  for (i = 0; i < ns; i++) cur[i] = 0;
  for (;;)
    { const uint8_t *m = 0;
      mi = -1;
      for (i = 0; i < ns; i++)
        if (cur[i] < lens[i])
          { const uint8_t *k = keys[i] + cur[i] * kb;
            if (mi < 0 || memcmp(k, m, kb) < 0)
              { m = k; mi = i; }
          }
      if (mi < 0) break;
      memcpy(out_keys + U * kb, m, kb);
      for (i = 0; i < ns; i++)
        if (cur[i] < lens[i] &&
            memcmp(keys[i] + cur[i] * kb, m, kb) == 0)
          { slots[i][cur[i]] = U;
            cur[i] += 1;
          }
      U += 1;
    }
  return U;
}

/* ------------------------------------------------------------------------
 * rANS-4x8 static decoder (the CRAM block codec, orders 0 and 1) — the
 * native fast path behind io/cram_native.py:rans_uncompress, which keeps a
 * pure-Python fallback with identical semantics (both mirror the CRAM 3.0
 * spec; the reference vendors htslib's rans_static.c for this role). SEQ
 * data series are rANS-compressed in practice, so this per-byte loop is
 * the CRAM ingest bottleneck.
 */

#define FK_TF_SHIFT 12
#define FK_TOTFREQ  (1u << FK_TF_SHIFT)
#define FK_RANS_LOW (1u << 23)

typedef struct
{ uint32_t F[256];
  uint32_t C[256];
  uint8_t  L[FK_TOTFREQ];
} FkRansTab;

/* Parse one order-0 frequency table (symbol-RLE; cumulative starts in
 * visit order; historical totals of 4095 repeat the last slot; in order-1
 * context rows a frequency of 0 means the whole table). Returns the new
 * read position or -1 on malformed input. */
static long fk_read_freqs0(const uint8_t *buf, long n, long pos,
                           int zero_is_total, FkRansTab *t)
{ unsigned x = 0, j, rle = 0;
  memset(t->F, 0, sizeof(t->F));
  memset(t->C, 0, sizeof(t->C));
  if (pos >= n) return -1;
  j = buf[pos++];
  for (;;)
    { unsigned f;
      if (pos >= n) return -1;
      f = buf[pos++];
      if (f >= 128)
        { if (pos >= n) return -1;
          f = ((f & 0x7f) << 8) | buf[pos++];
        }
      if (f == 0 && zero_is_total)
        f = FK_TOTFREQ;
      t->F[j] = f;
      t->C[j] = x;
      if (x + f > FK_TOTFREQ) return -1;
      memset(t->L + x, (int)j, f);
      x += f;
      if (rle > 0)
        { rle -= 1;
          j += 1;
          if (j > 255) return -1;   /* symbol RLE past 255: malformed */
        }
      else
        { unsigned nj;
          if (pos >= n) return -1;
          nj = buf[pos++];
          if (nj == j + 1)
            { if (pos >= n) return -1;
              rle = buf[pos++];
            }
          j = nj;
        }
      if (j == 0) break;
    }
  if (x < FK_TOTFREQ - 1 || x > FK_TOTFREQ) return -1;
  if (x < FK_TOTFREQ)
    t->L[x] = t->L[x - 1];
  return pos;
}

/* Decode a whole rANS payload (everything after the 9-byte
 * order/csize/usize header) into out[out_sz]. order is 0 or 1.
 * Returns the number of payload bytes consumed, or -1 on error. */
long fk_rans_decode(const uint8_t *buf, long n, int order,
                    uint8_t *out, long out_sz)
{ uint32_t states[4];
  long pos = 0, i;
  int j;

  if (order == 0)
    { FkRansTab *t = (FkRansTab *)malloc(sizeof(FkRansTab));
      if (t == NULL) return -1;
      pos = fk_read_freqs0(buf, n, 0, 0, t);
      if (pos < 0 || pos + 16 > n)
        { free(t); return -1; }
      for (j = 0; j < 4; j++)
        { states[j] = (uint32_t)buf[pos] | ((uint32_t)buf[pos+1] << 8)
                    | ((uint32_t)buf[pos+2] << 16)
                    | ((uint32_t)buf[pos+3] << 24);
          pos += 4;
        }
      for (i = 0; i < out_sz; i++)
        { uint32_t x = states[i & 3];
          unsigned m = x & (FK_TOTFREQ - 1);
          unsigned s = t->L[m];
          out[i] = (uint8_t)s;
          x = t->F[s] * (x >> FK_TF_SHIFT) + m - t->C[s];
          while (x < FK_RANS_LOW && pos < n)
            x = (x << 8) | buf[pos++];
          states[i & 3] = x;
        }
      free(t);
      return pos;
    }

  if (order == 1)
    { FkRansTab *tabs = (FkRansTab *)malloc(256 * sizeof(FkRansTab));
      uint8_t present[256];
      unsigned ci, rle_i = 0, ctx[4] = {0, 0, 0, 0};
      long isz4 = out_sz >> 2;
      if (tabs == NULL) return -1;
      memset(present, 0, sizeof(present));
      if (n < 1)
        { free(tabs); return -1; }
      ci = buf[pos++];
      for (;;)
        { pos = fk_read_freqs0(buf, n, pos, 1, &tabs[ci]);
          if (pos < 0)
            { free(tabs); return -1; }
          present[ci] = 1;
          if (rle_i > 0)
            { rle_i -= 1;
              ci += 1;
              if (ci > 255)          /* context RLE past 255: malformed */
                { free(tabs); return -1; }
            }
          else
            { unsigned ni;
              if (pos >= n)
                { free(tabs); return -1; }
              ni = buf[pos++];
              if (ni == ci + 1)
                { if (pos >= n)
                    { free(tabs); return -1; }
                  rle_i = buf[pos++];
                }
              ci = ni;
            }
          if (ci == 0) break;
        }
      if (pos + 16 > n)
        { free(tabs); return -1; }
      for (j = 0; j < 4; j++)
        { states[j] = (uint32_t)buf[pos] | ((uint32_t)buf[pos+1] << 8)
                    | ((uint32_t)buf[pos+2] << 16)
                    | ((uint32_t)buf[pos+3] << 24);
          pos += 4;
        }
      for (i = 0; i < isz4; i++)
        for (j = 0; j < 4; j++)
          { uint32_t x = states[j];
            unsigned m = x & (FK_TOTFREQ - 1);
            FkRansTab *t;
            unsigned s;
            if (!present[ctx[j]])
              { free(tabs); return -1; }
            t = &tabs[ctx[j]];
            s = t->L[m];
            out[(long)j * isz4 + i] = (uint8_t)s;
            x = t->F[s] * (x >> FK_TF_SHIFT) + m - t->C[s];
            while (x < FK_RANS_LOW && pos < n)
              x = (x << 8) | buf[pos++];
            states[j] = x;
            ctx[j] = s;
          }
      for (i = 4 * isz4; i < out_sz; i++)   /* remainder rides state 3 */
        { uint32_t x = states[3];
          unsigned m = x & (FK_TOTFREQ - 1);
          FkRansTab *t;
          unsigned s;
          if (!present[ctx[3]])
            { free(tabs); return -1; }
          t = &tabs[ctx[3]];
          s = t->L[m];
          out[i] = (uint8_t)s;
          x = t->F[s] * (x >> FK_TF_SHIFT) + m - t->C[s];
          while (x < FK_RANS_LOW && pos < n)
            x = (x << 8) | buf[pos++];
          states[3] = x;
          ctx[3] = s;
        }
      free(tabs);
      return pos;
    }

  return -1;
}

/* Decode one compressed profile (the .prof delta codec,
 * reference decoder libfastk.c:1710-1805). Returns the count of values
 * written to out (capacity ocap), or -1 on overflow / malformed input. */
long fk_prof_decode(const uint8_t *buf, long n, uint16_t *out, long ocap)
{ long i = 0, m = 0;
  unsigned cur;
  if (n == 0) return 0;
  if (buf[0] & 0x80)
    { if (n < 2) return -1;
      cur = ((unsigned)(buf[0] & 0x7f) << 8) | buf[1];
      i = 2;
    }
  else
    { cur = buf[0];
      i = 1;
    }
  if (m >= ocap) return -1;
  out[m++] = (uint16_t)cur;
  while (i < n)
    { unsigned b = buf[i++];
      if (b & 0x80)
        { unsigned v;
          if (i >= n) return -1;
          v = ((b & 0x7f) << 8) | buf[i++];
          cur = (cur + v) & 0x7fff;
          if (m >= ocap) return -1;
          out[m++] = (uint16_t)cur;
        }
      else if (b & 0x40)
        { int d = b & 0x3f;
          if (d >= 0x20) d -= 0x40;
          cur = (unsigned)(((int)cur + d) & 0x7fff);
          if (m >= ocap) return -1;
          out[m++] = (uint16_t)cur;
        }
      else
        { unsigned j;
          if (b == 0) return -1;
          if (m + b > (unsigned long)ocap) return -1;
          for (j = 0; j < b; j++)
            out[m++] = (uint16_t)cur;
        }
    }
  return m;
}

/* ------------------------------------------------------------------------
 * Streamed-table-tool fast paths (fastmerge/logex/vennex window engine).
 * The reference streams .ktab records through C table_threads
 * (Fastmerge.c:80-450); our window engine keeps the orchestration in
 * Python but runs the three per-record loops natively:
 *   fk_read_range      part-file records -> full-key rows (the prefix
 *                      bytes are implied by the stub's cumulative index)
 *   fk_merge_sum_rows  k-way sorted merge with count sums (fastmerge's
 *                      combine; fk_union_slots covers logex/vennex)
 *   fk_writer_add      KtabWriter chunk append: row assembly + the
 *                      2-byte-prefix histogram for the stub index
 */

/* Fill rows [lo, hi) of a table as (hi-lo) x (kb + 2) implicit pairs:
 * out_packed gets kb-byte full keys, out_counts the uint16 counts.
 * parts[p] points at part p's first record (12-byte header skipped),
 * part_nels[p] its record count; pindex is the stub's cumulative prefix
 * index (length plen = 2^(8*ibyte), pindex[plen-1] == total records).
 * Returns hi - lo, or -1 on inconsistent bounds. */
long fk_read_range(int kb, int ibyte, int nparts,
                   const uint8_t **parts, const int64_t *part_nels,
                   const int64_t *pindex, long plen,
                   long lo, long hi,
                   uint8_t *out_packed, uint16_t *out_counts)
{ int  sbyte = kb - ibyte;
  int  rb = sbyte + 2;
  long i = lo, o = 0;
  long pv, plo, phi;
  int  p = 0;
  long pbase = 0;
  const uint8_t *rp;
  long pleft;
  if (lo < 0 || hi < lo || pindex[plen - 1] < hi) return -1;
  /* part containing lo */
  while (p < nparts && pbase + part_nels[p] <= lo)
    { pbase += part_nels[p]; p += 1; }
  if (p >= nparts && lo < hi) return -1;
  rp = (p < nparts) ? parts[p] + (lo - pbase) * rb : 0;
  pleft = (p < nparts) ? part_nels[p] - (lo - pbase) : 0;
  /* prefix of lo: first pv with pindex[pv] > lo (binary search) */
  plo = 0; phi = plen - 1;
  while (plo < phi)
    { pv = (plo + phi) >> 1;
      if (pindex[pv] <= lo) plo = pv + 1; else phi = pv;
    }
  pv = plo;
  while (i < hi)
    { uint8_t *ok;
      int b;
      while (pindex[pv] <= i) pv += 1;   /* advance prefix */
      while (pleft == 0)
        { pbase += part_nels[p]; p += 1;
          if (p >= nparts) return -1;
          rp = parts[p]; pleft = part_nels[p];
        }
      ok = out_packed + o * kb;
      for (b = 0; b < ibyte; b++)
        ok[b] = (uint8_t)(pv >> (8 * (ibyte - 1 - b)));
      for (b = 0; b < sbyte; b++)
        ok[ibyte + b] = rp[b];
      out_counts[o] = (uint16_t)(rp[sbyte] | ((uint16_t)rp[sbyte + 1] << 8));
      rp += rb; pleft -= 1; i += 1; o += 1;
    }
  return o;
}

/* K-way merge of ns sorted-unique key streams with per-key count sums
 * (int32 accumulate; the tool clips to 0x7fff on write). Returns the
 * union size. Same linear min-scan as fk_union_slots. */
long fk_merge_sum_rows(int kb, int ns, const uint8_t **keys,
                       const int64_t *lens, const uint16_t **cnts,
                       uint8_t *out_keys, int32_t *out_sums)
{ int64_t cur[64];
  int     i, mi;
  long    U = 0;
  if (ns > 64) return -1;
  for (i = 0; i < ns; i++) cur[i] = 0;
  for (;;)
    { const uint8_t *m = 0;
      int32_t s = 0;
      mi = -1;
      for (i = 0; i < ns; i++)
        if (cur[i] < lens[i])
          { const uint8_t *k = keys[i] + cur[i] * kb;
            if (mi < 0 || memcmp(k, m, kb) < 0)
              { m = k; mi = i; }
          }
      if (mi < 0) break;
      memcpy(out_keys + U * kb, m, kb);
      for (i = 0; i < ns; i++)
        if (cur[i] < lens[i] &&
            memcmp(keys[i] + cur[i] * kb, m, kb) == 0)
          { s += cnts[i][cur[i]];
            cur[i] += 1;
          }
      out_sums[U] = s;
      U += 1;
    }
  return U;
}

/* KtabWriter.add: assemble (m, kb+2) records from keys + LE counts and
 * accumulate the 2-byte key-prefix histogram (single-byte keys use
 * prefix<<8, matching the writer's stub rule). */
void fk_writer_add(int kb, long m, const uint8_t *packed,
                   const uint16_t *counts, uint8_t *rec, int64_t *h2)
{ long i;
  int  rb = kb + 2;
  for (i = 0; i < m; i++)
    { const uint8_t *k = packed + i * kb;
      uint8_t *r = rec + i * rb;
      int pv;
      memcpy(r, k, kb);
      r[kb] = (uint8_t)(counts[i] & 0xff);
      r[kb + 1] = (uint8_t)(counts[i] >> 8);
      pv = ((int)k[0] << 8) | (kb > 1 ? k[1] : 0);
      h2[pv] += 1;
    }
}

/* Fused fastmerge inner loop: k-way merge of ns sources DIRECTLY from
 * their part-file memmaps into writer-format (kb+2)-byte records with
 * clipped summed counts, accumulating the writer's 2-byte-prefix
 * histogram (h2) and the merged count histogram (chist, 32768 bins) in
 * the same pass — the whole window becomes one C call (the role of the
 * reference's table_thread, Fastmerge.c:80-450). Sources are cursors
 * over [lo, hi) record ranges; full keys are reconstructed from each
 * stub's cumulative prefix index as the cursor advances.
 *
 * Layout of flattened args: source s owns parts part_off[s]..part_off[s+1]
 * of (part_ptrs, part_nels); pindexes[s] has plens[s] int64 entries;
 * ibytes[s] is its stub's prefix width. out_rec must hold sum(hi-lo)
 * records. Returns the union size, or -1 on malformed input.
 */
typedef struct
{ const uint8_t **parts;
  const int64_t  *nels;
  int             npart, pi;
  const int64_t  *pindex;
  long            plen;
  int             ibyte, sbyte, rb;
  const uint8_t  *rp;       /* current record */
  long            left;     /* records left in current part */
  int64_t         ord, end; /* global ordinal, end ordinal */
  long            pv;       /* current prefix value */
  uint8_t         key[64];  /* materialized full key */
} FkCur;

static int fk_cur_load(FkCur *c)
{ int b;
  while (c->pindex[c->pv] <= c->ord) c->pv += 1;
  for (b = 0; b < c->ibyte; b++)
    c->key[b] = (uint8_t)(c->pv >> (8 * (c->ibyte - 1 - b)));
  for (b = 0; b < c->sbyte; b++)
    c->key[c->ibyte + b] = c->rp[b];
  return 0;
}

static int fk_cur_advance(FkCur *c)
{ c->ord += 1;
  if (c->ord >= c->end) return 0;
  c->rp += c->rb;
  c->left -= 1;
  while (c->left == 0)
    { c->pi += 1;
      if (c->pi >= c->npart) return -1;
      c->rp = c->parts[c->pi];
      c->left = c->nels[c->pi];
    }
  fk_cur_load(c);
  return 1;
}

/* Lexicographic key compare via bswapped unaligned 64-bit words (keys are
 * big-endian byte strings, so byte order == numeric order of the swapped
 * words): ~3x faster than memcmp calls at kb ~ 10. */
static inline int fk_keycmp(const uint8_t *a, const uint8_t *b, int kb)
{ int i = 0;
  for (; i + 8 <= kb; i += 8)
    { uint64_t x, y;
      memcpy(&x, a + i, 8);
      memcpy(&y, b + i, 8);
      if (x != y)
        { x = __builtin_bswap64(x);
          y = __builtin_bswap64(y);
          return x < y ? -1 : 1;
        }
    }
  for (; i < kb; i++)
    if (a[i] != b[i])
      return a[i] < b[i] ? -1 : 1;
  return 0;
}

/* Emit cursor c's current record (count = own count unless sum >= 0
 * overrides) and advance; shared by the 2-way fast path. */
static inline int fk_emit(FkCur *c, long s, uint8_t *r, int kb,
                          int64_t *h2, int64_t *chist)
{ int pv2;
  memcpy(r, c->key, kb);
  if (s > 0x7fff) s = 0x7fff;
  r[kb] = (uint8_t)(s & 0xff);
  r[kb + 1] = (uint8_t)(s >> 8);
  pv2 = ((int)r[0] << 8) | (kb > 1 ? r[1] : 0);
  h2[pv2] += 1;
  chist[s] += 1;
  return fk_cur_advance(c);
}

static inline long fk_cur_count(const FkCur *c)
{ return (long)(c->rp[c->sbyte] | ((uint16_t)c->rp[c->sbyte + 1] << 8)); }

/* 2-source merge loop: one key compare per output record plus a
 * comparison-free drain once either side exhausts. */
static long fk_merge2(FkCur *a, FkCur *b, int kb, uint8_t *out_rec,
                      long cap, int64_t *h2, int64_t *chist)
{ long U = 0;
  int  orb = kb + 2;
  int  alive_a = a->ord < a->end, alive_b = b->ord < b->end;
  while (alive_a && alive_b)
    { int c = fk_keycmp(a->key, b->key, kb);
      if (U >= cap) return -1;
      if (c < 0)
        alive_a = fk_emit(a, fk_cur_count(a), out_rec + U * orb, kb,
                          h2, chist);
      else if (c > 0)
        alive_b = fk_emit(b, fk_cur_count(b), out_rec + U * orb, kb,
                          h2, chist);
      else
        { long s = fk_cur_count(a) + fk_cur_count(b);
          alive_a = fk_emit(a, s, out_rec + U * orb, kb, h2, chist);
          alive_b = fk_cur_advance(b);
        }
      if (alive_a < 0 || alive_b < 0) return -1;
      U += 1;
    }
  while (alive_a || alive_b)
    { FkCur *c = alive_a ? a : b;
      int r;
      if (U >= cap) return -1;
      r = fk_emit(c, fk_cur_count(c), out_rec + U * orb, kb, h2, chist);
      if (r < 0) return -1;
      if (alive_a) alive_a = r; else alive_b = r;
      U += 1;
    }
  return U;
}

static int fk_cur_init(FkCur *c, int kb, int i,
                       const uint8_t **part_ptrs, const int64_t *part_nels,
                       const int32_t *part_off,
                       const int64_t **pindexes, const int64_t *plens,
                       const int32_t *ibytes,
                       const int64_t *lo, const int64_t *hi)
{ long base = 0, plo, phi, mid;
  c->parts = part_ptrs + part_off[i];
  c->nels = part_nels + part_off[i];
  c->npart = part_off[i + 1] - part_off[i];
  c->pindex = pindexes[i];
  c->plen = plens[i];
  c->ibyte = ibytes[i];
  c->sbyte = kb - c->ibyte;
  c->rb = c->sbyte + 2;
  c->ord = lo[i];
  c->end = hi[i];
  if (c->ord >= c->end) return 0;
  c->pi = 0;
  while (c->pi < c->npart && base + c->nels[c->pi] <= c->ord)
    { base += c->nels[c->pi]; c->pi += 1; }
  if (c->pi >= c->npart) return -1;
  c->rp = c->parts[c->pi] + (c->ord - base) * c->rb;
  c->left = c->nels[c->pi] - (c->ord - base);
  plo = 0; phi = c->plen - 1;
  while (plo < phi)
    { mid = (plo + phi) >> 1;
      if (c->pindex[mid] <= c->ord) plo = mid + 1; else phi = mid;
    }
  c->pv = plo;
  fk_cur_load(c);
  return 1;
}

long fk_merge_windows(int kb, int ns,
                      const uint8_t **part_ptrs, const int64_t *part_nels,
                      const int32_t *part_off,
                      const int64_t **pindexes, const int64_t *plens,
                      const int32_t *ibytes,
                      const int64_t *lo, const int64_t *hi,
                      uint8_t *out_rec, long cap,
                      int64_t *h2, int64_t *chist)
{ FkCur cur[64];
  int   i;
  long  U = 0;
  int   orb = kb + 2;
  if (ns > 64 || kb > 62) return -1;
  for (i = 0; i < ns; i++)
    if (fk_cur_init(cur + i, kb, i, part_ptrs, part_nels, part_off,
                    pindexes, plens, ibytes, lo, hi) < 0)
      return -1;
  if (ns == 2)
    return fk_merge2(cur, cur + 1, kb, out_rec, cap, h2, chist);
  for (;;)
    { const uint8_t *m = 0;
      long s = 0;
      uint8_t *r;
      int pv2;
      for (i = 0; i < ns; i++)
        if (cur[i].ord < cur[i].end)
          { if (m == 0 || fk_keycmp(cur[i].key, m, kb) < 0)
              m = cur[i].key;
          }
      if (m == 0) break;
      if (U >= cap) return -1;
      r = out_rec + U * orb;
      memcpy(r, m, kb);
      for (i = 0; i < ns; i++)
        { FkCur *c = cur + i;
          if (c->ord < c->end && fk_keycmp(c->key, r, kb) == 0)
            { s += fk_cur_count(c);
              if (fk_cur_advance(c) < 0) return -1;
            }
        }
      if (s > 0x7fff) s = 0x7fff;
      r[kb] = (uint8_t)(s & 0xff);
      r[kb + 1] = (uint8_t)(s >> 8);
      pv2 = ((int)r[0] << 8) | (kb > 1 ? r[1] : 0);
      h2[pv2] += 1;
      chist[s] += 1;
      U += 1;
    }
  return U;
}

/* Windowed k-way UNION with per-source aligned count vectors, straight
 * from the part memmaps (the logex/vennex window engine: the role of
 * Logex.c's streaming per-bucket evaluation input stage). out_keys gets
 * the sorted unique union as (U, kb) rows; out_cnts is ns row-major
 * vectors of length cap: out_cnts[i*cap + u] = source i's count of union
 * key u (0 if absent). Returns U, or -1 on malformed input. */
long fk_union_cvecs(int kb, int ns,
                    const uint8_t **part_ptrs, const int64_t *part_nels,
                    const int32_t *part_off,
                    const int64_t **pindexes, const int64_t *plens,
                    const int32_t *ibytes,
                    const int64_t *lo, const int64_t *hi,
                    uint8_t *out_keys, long cap, uint16_t *out_cnts)
{ FkCur cur[64];
  int   i;
  long  U = 0;
  if (ns > 64 || kb > 62) return -1;
  for (i = 0; i < ns; i++)
    if (fk_cur_init(cur + i, kb, i, part_ptrs, part_nels, part_off,
                    pindexes, plens, ibytes, lo, hi) < 0)
      return -1;
  if (ns == 2)
    { FkCur *a = cur, *b = cur + 1;
      uint16_t *ca = out_cnts, *cb = out_cnts + cap;
      int alive_a = a->ord < a->end, alive_b = b->ord < b->end;
      while (alive_a && alive_b)
        { int c = fk_keycmp(a->key, b->key, kb);
          if (U >= cap) return -1;
          if (c <= 0)
            { memcpy(out_keys + U * kb, a->key, kb);
              ca[U] = (uint16_t)fk_cur_count(a);
              cb[U] = (c == 0) ? (uint16_t)fk_cur_count(b) : 0;
              alive_a = fk_cur_advance(a);
              if (c == 0) alive_b = fk_cur_advance(b);
            }
          else
            { memcpy(out_keys + U * kb, b->key, kb);
              ca[U] = 0;
              cb[U] = (uint16_t)fk_cur_count(b);
              alive_b = fk_cur_advance(b);
            }
          if (alive_a < 0 || alive_b < 0) return -1;
          U += 1;
        }
      while (alive_a || alive_b)
        { FkCur *c = alive_a ? a : b;
          int r;
          if (U >= cap) return -1;
          memcpy(out_keys + U * kb, c->key, kb);
          ca[U] = alive_a ? (uint16_t)fk_cur_count(c) : 0;
          cb[U] = alive_a ? 0 : (uint16_t)fk_cur_count(c);
          r = fk_cur_advance(c);
          if (r < 0) return -1;
          if (alive_a) alive_a = r; else alive_b = r;
          U += 1;
        }
      return U;
    }
  for (;;)
    { const uint8_t *m = 0;
      uint8_t *r;
      for (i = 0; i < ns; i++)
        if (cur[i].ord < cur[i].end)
          { if (m == 0 || fk_keycmp(cur[i].key, m, kb) < 0)
              m = cur[i].key;
          }
      if (m == 0) break;
      if (U >= cap) return -1;
      r = out_keys + U * kb;
      memcpy(r, m, kb);
      for (i = 0; i < ns; i++)
        { FkCur *c = cur + i;
          if (c->ord < c->end && fk_keycmp(c->key, r, kb) == 0)
            { out_cnts[(long)i * cap + U] = (uint16_t)fk_cur_count(c);
              if (fk_cur_advance(c) < 0) return -1;
            }
          else
            out_cnts[(long)i * cap + U] = 0;
        }
      U += 1;
    }
  return U;
}

/* ------------------------------------------------------------------
 * Fused logex window engine: the k-way cursor union above, but with the
 * compiled expression evaluated PER UNION KEY inside the merge loop, so
 * every logex expression shape (not just sum-unions) streams single-pass
 * from the part memmaps to writer rows — the role of the reference's
 * per-thread truth-table stream merge (Logex.c:972-1215 merge_thread,
 * eval_expression Logex.c:660-750), with the expression compiled to a
 * small stack program instead of a function tree.
 *
 * Program encoding (int32 words, produced by algebra.compile_program):
 *   ARG var          push source var's count
 *   NUM              x -> (x > 0)                   ('#')
 *   CNT n lo1 hi1..  x -> x if x in any range else 0  ('[a-b]')
 *   GC  n lo1 hi1..  x -> x if key GC%% in any range else 0  ('{a-b}')
 *   OR mode / AND mode / XOR / MINUS   binary combiners; mode is
 *     0 none -> 1, 1 '+' sum, 2 '-' floored sub, 3 '<' min, 4 '>' max,
 *     5 '*' floor-avg, 6 '.' left-else-right
 * Semantics mirror algebra.evaluate exactly (count 0 == absent).       */

enum { LXO_ARG, LXO_NUM, LXO_CNT, LXO_GC,
       LXO_OR, LXO_AND, LXO_XOR, LXO_MINUS };

static int64_t fk_lx_mod(int64_t x, int64_t y, int mode)
{ switch (mode)
    { case 1: return x + y;
      case 2: return x > y ? x - y : 0;
      case 3: return x < y ? x : y;
      case 4: return x > y ? x : y;
      case 5: return (x + y) >> 1;
      case 6: return x ? x : y;
      default: return 1;
    }
}

static int64_t fk_lx_eval(const int32_t *prog, int plen,
                          const int64_t *cnt, int gcv)
{ int64_t st[64];
  int sp = 0, pc = 0;
  while (pc < plen)
    { int op = prog[pc++];
      switch (op)
        { case LXO_ARG:
            st[sp++] = cnt[prog[pc++]];
            break;
          case LXO_NUM:
            st[sp - 1] = st[sp - 1] > 0;
            break;
          case LXO_CNT:
            { int n = prog[pc++], j, ok = 0;
              int64_t x = st[sp - 1];
              for (j = 0; j < n; j++)
                if (x >= prog[pc + 2 * j] && x <= prog[pc + 2 * j + 1])
                  { ok = 1; break; }
              if (!ok) st[sp - 1] = 0;
              pc += 2 * n;
            }
            break;
          case LXO_GC:
            { int n = prog[pc++], j, ok = 0;
              for (j = 0; j < n; j++)
                if (gcv >= prog[pc + 2 * j] && gcv <= prog[pc + 2 * j + 1])
                  { ok = 1; break; }
              if (!ok) st[sp - 1] = 0;
              pc += 2 * n;
            }
            break;
          case LXO_OR:
            { int mode = prog[pc++];
              int64_t y = st[--sp], x = st[sp - 1];
              st[sp - 1] = (x == 0) ? y
                           : (y == 0 ? x : fk_lx_mod(x, y, mode));
            }
            break;
          case LXO_AND:
            { int mode = prog[pc++];
              int64_t y = st[--sp], x = st[sp - 1];
              st[sp - 1] = (x == 0 || y == 0) ? 0 : fk_lx_mod(x, y, mode);
            }
            break;
          case LXO_XOR:
            { int64_t y = st[--sp], x = st[sp - 1];
              st[sp - 1] = (x == 0) ? y : (y == 0 ? x : 0);
            }
            break;
          case LXO_MINUS:
            { int64_t y = st[--sp], x = st[sp - 1];
              st[sp - 1] = (y == 0) ? x : 0;
            }
            break;
          default:
            return 0;
        }
    }
  return st[0];
}

/* GC codes per byte: 2-bit fields equal to 1 (C) or 2 (G); trailing pad
 * codes are 0 (A) so whole-byte sums are safe at any k. */
static uint8_t fk_gctab[256];

static void init_gctab(void)
{ int b, f;
  for (b = 0; b < 256; b++)
    { int n = 0;
      for (f = 0; f < 4; f++)
        { int c = (b >> (2 * f)) & 3;
          if (c == 1 || c == 2) n += 1;
        }
      fk_gctab[b] = (uint8_t)n;
    }
}

/* Per-key tail shared by the merge loops below: evaluate every
 * assignment's program on the gathered counts and emit/accumulate. */
static inline long fk_lx_key(const uint8_t *key, const int64_t *cnt,
                             int kb, int kmer,
                             const int32_t *prog, const int64_t *prog_off,
                             int nasg, int need_gc,
                             uint8_t **out_recs, long cap, int64_t *h2,
                             int do_hist, int hlow, int hhigh, long hspan,
                             int64_t *hbins, int64_t *hsum, int64_t *out_u)
{ int a, orb = kb + 2;
  int gcv = 0;
  if (need_gc)
    { int ngc = 0, b;
      for (b = 0; b < kb; b++) ngc += fk_gctab[key[b]];
      gcv = (int)((100L * ngc) / kmer);
    }
  for (a = 0; a < nasg; a++)
    { int64_t v = fk_lx_eval(prog + prog_off[a],
                             (int)(prog_off[a + 1] - prog_off[a]),
                             cnt, gcv);
      if (v <= 0) continue;
      if (do_hist)
        { int64_t cl = v < hlow ? hlow : (v > hhigh ? hhigh : v);
          hbins[a * hspan + (cl - hlow)] += 1;
          if (v <= hlow) hsum[a * 2] += v;
          if (v >= hhigh) hsum[a * 2 + 1] += v;
        }
      if (out_recs)
        { uint8_t *r;
          long s = v > 0x7fff ? 0x7fff : (long)v;
          if (out_u[a] >= cap) return -1;
          r = out_recs[a] + out_u[a] * orb;
          memcpy(r, key, kb);
          r[kb] = (uint8_t)(s & 0xff);
          r[kb + 1] = (uint8_t)(s >> 8);
          h2[(long)a * 65536
             + (((int)key[0] << 8) | (kb > 1 ? key[1] : 0))] += 1;
          out_u[a] += 1;
        }
      else
        out_u[a] += 1;
    }
  return 0;
}

/* Stream [lo, hi) cursor ranges of ns sources through nasg compiled
 * expressions: per union key, gather per-source counts, evaluate each
 * program, and for accepted keys (value > 0) emit a writer-format row
 * into that assignment's buffer (clipped at 0x7fff) + its 2-byte-prefix
 * histogram, and/or accumulate its [hlow, hhigh] boundary histogram
 * (unique bins + instance sums at the boundaries, Logex.c:1143-1165
 * semantics). out_recs may be NULL (histogram-only, Logex -H).
 *
 * solo_ok: bit i set iff some assignment can yield output for a key
 * present ONLY in source i (algebra._solo_emits proves this exhaustively
 * over the 2^15 possible counts) — unset bits let the merge skip
 * evaluation AND emission for single-source keys, so sparse-output
 * expressions (intersections, differences) stream at cursor-walk speed
 * instead of eval speed. The reference walks + evaluates every key
 * (Logex.c:972-1215); this skip is the windowed engine\'s advantage.
 *
 * Returns 0, or -1 on malformed input / capacity overflow. */
long fk_logex_windows(int kb, int kmer, int ns,
                      const uint8_t **part_ptrs, const int64_t *part_nels,
                      const int32_t *part_off,
                      const int64_t **pindexes, const int64_t *plens,
                      const int32_t *ibytes,
                      const int64_t *lo, const int64_t *hi,
                      const int32_t *prog, const int64_t *prog_off,
                      int nasg, int need_gc, int64_t solo_ok,
                      uint8_t **out_recs, long cap, int64_t *h2,
                      int do_hist, int hlow, int hhigh,
                      int64_t *hbins, int64_t *hsum,
                      int64_t *out_u)
{ FkCur   cur[64];
  int64_t cnt[64];
  uint8_t key[64];
  int     i, a;
  long    hspan = (long)hhigh - hlow + 1;
  if (ns > 64 || kb > 62 || nasg > 16) return -1;
  for (i = 0; i < ns; i++)
    if (fk_cur_init(cur + i, kb, i, part_ptrs, part_nels, part_off,
                    pindexes, plens, ibytes, lo, hi) < 0)
      return -1;
  for (a = 0; a < nasg; a++) out_u[a] = 0;

#define FK_LX_EMIT() \
  do { if (fk_lx_key(key, cnt, kb, kmer, prog, prog_off, nasg, need_gc, \
                     out_recs, cap, h2, do_hist, hlow, hhigh, hspan,    \
                     hbins, hsum, out_u) < 0) return -1; } while (0)

  if (ns == 1)
    { FkCur *A = cur;
      int alive = A->ord < A->end;
      while (alive)
        { memcpy(key, A->key, kb);
          cnt[0] = fk_cur_count(A);
          FK_LX_EMIT();
          alive = fk_cur_advance(A);
          if (alive < 0) return -1;
        }
      return 0;
    }

  if (ns == 2)
    { FkCur *A = cur, *B = cur + 1;
      int alive_a = A->ord < A->end, alive_b = B->ord < B->end;
      int ok_a = (solo_ok >> 0) & 1, ok_b = (solo_ok >> 1) & 1;
      while (alive_a && alive_b)
        { int c = fk_keycmp(A->key, B->key, kb);
          if (c < 0)
            { if (ok_a)
                { memcpy(key, A->key, kb);
                  cnt[0] = fk_cur_count(A); cnt[1] = 0;
                  FK_LX_EMIT();
                }
              alive_a = fk_cur_advance(A);
              if (alive_a < 0) return -1;
            }
          else if (c > 0)
            { if (ok_b)
                { memcpy(key, B->key, kb);
                  cnt[0] = 0; cnt[1] = fk_cur_count(B);
                  FK_LX_EMIT();
                }
              alive_b = fk_cur_advance(B);
              if (alive_b < 0) return -1;
            }
          else
            { memcpy(key, A->key, kb);
              cnt[0] = fk_cur_count(A); cnt[1] = fk_cur_count(B);
              FK_LX_EMIT();
              alive_a = fk_cur_advance(A);
              alive_b = fk_cur_advance(B);
              if (alive_a < 0 || alive_b < 0) return -1;
            }
        }
      while (alive_a)
        { if (ok_a)
            { memcpy(key, A->key, kb);
              cnt[0] = fk_cur_count(A); cnt[1] = 0;
              FK_LX_EMIT();
            }
          alive_a = fk_cur_advance(A);
          if (alive_a < 0) return -1;
        }
      while (alive_b)
        { if (ok_b)
            { memcpy(key, B->key, kb);
              cnt[0] = 0; cnt[1] = fk_cur_count(B);
              FK_LX_EMIT();
            }
          alive_b = fk_cur_advance(B);
          if (alive_b < 0) return -1;
        }
      return 0;
    }

  for (;;)
    { const uint8_t *m = 0;
      uint64_t mask = 0;
      int      nsolo = -1;
      for (i = 0; i < ns; i++)
        if (cur[i].ord < cur[i].end)
          { if (m == 0 || fk_keycmp(cur[i].key, m, kb) < 0)
              m = cur[i].key;
          }
      if (m == 0) break;
      memcpy(key, m, kb);            /* cursors mutate on advance */
      for (i = 0; i < ns; i++)
        { FkCur *c = cur + i;
          if (c->ord < c->end && fk_keycmp(c->key, key, kb) == 0)
            { cnt[i] = fk_cur_count(c);
              mask |= (uint64_t)1 << i;
              nsolo = (mask == ((uint64_t)1 << i)) ? i : -2;
              if (fk_cur_advance(c) < 0) return -1;
            }
          else
            cnt[i] = 0;
        }
      if (nsolo >= 0 && !((solo_ok >> nsolo) & 1))
        continue;
      FK_LX_EMIT();
    }
  return 0;
#undef FK_LX_EMIT
}

/* ------------------------------------------------------------------ */
/* BAM / SAM record scanners (the reference scans both in threaded C,
 * io.c:1317-1654; these are the TPU build's host-side equivalents,
 * feeding the same worker pool as fk_scan_seq).                       */

/* BAM 4-bit SEQ nibbles -> IUPAC letters (SAM spec; reference io.c:1313) */
static const uint8_t NIB[16] = "=ACMGRSVTWYHKDBN";

/* payload byte -> two codes at once (the no-hc/no-bc fast path) */
static uint8_t NIB2[256][2];
static int nib2_init = 0;
static void init_nib2(void)
{ int b;
  if (nib2_init) return;
  init_code();
  for (b = 0; b < 256; b++)
    { NIB2[b][0] = CODE[NIB[b >> 4]];
      NIB2[b][1] = CODE[NIB[b & 0xF]];
    }
  nib2_init = 1;
}

/* Scan WHOLE BAM alignment records from buf (header already stripped).
 * Skips FLAG & 0x900 (secondary|supplementary) and l_seq <= 0 records;
 * nibbles decode through NIB then CODE (non-acgt letters stay invalid,
 * matching io/sam.py); hc compresses equal consecutive LETTERS; bc drops
 * leading bases after hc. Stops cleanly before a trailing partial record
 * and reports bytes consumed.
 * Returns #reads emitted, -1 codes overflow, -2 rcap overflow. */
long fk_scan_bam(const uint8_t *buf, long n, int hc, int bc,
                 uint8_t *codes, long ccap,
                 int64_t *boff, int64_t *rlen, long rcap,
                 int64_t *consumed)
{ long i = 0, o = 0, r = 0;
  init_code();
  init_nib2();

  while (i + 4 <= n)
    { long bs = (long)buf[i] | ((long)buf[i+1] << 8)
              | ((long)buf[i+2] << 16) | ((long)buf[i+3] << 24);
      const uint8_t *rec;
      long lname, ncig, flag, lseq, off, nb, j;
      if (bs < 32) { *consumed = i; return -3; }
      if (i + 4 + bs > n) break;               /* partial record: carry */
      rec   = buf + i + 4;
      i    += 4 + bs;
      lname = rec[8];
      ncig  = (long)rec[12] | ((long)rec[13] << 8);
      flag  = (long)rec[14] | ((long)rec[15] << 8);
      lseq  = (long)rec[16] | ((long)rec[17] << 8)
            | ((long)rec[18] << 16) | ((long)rec[19] << 24);
      if (flag & 0x900 || lseq <= 0) continue;
      off = 32 + lname + 4*ncig;
      nb  = (lseq + 1) / 2;
      if (off + nb > bs) { *consumed = i; return -3; }
      if (r >= rcap) return -2;
      boff[r] = o;
      if (!hc && !bc)
        { /* fast path: two codes per payload byte via a 256x2 table */
          long start = o;
          const uint8_t *p = rec + off;
          if (o + lseq + 1 > ccap) return -1;
          for (j = 0; j + 2 <= lseq; j += 2)
            { codes[o]   = NIB2[p[j >> 1]][0];
              codes[o+1] = NIB2[p[j >> 1]][1];
              o += 2;
            }
          if (lseq & 1)
            codes[o++] = NIB2[p[lseq >> 1]][0];
          rlen[r] = o - start;
          r++;
          codes[o++] = 4;                      /* read separator */
        }
      else
        { int  prev = -1;
          long kept = 0, start = o;
          for (j = 0; j < lseq; j++)
            { int nibble = (j & 1) ? (rec[off + j/2] & 0xF)
                                   : (rec[off + j/2] >> 4);
              int ch = NIB[nibble];
              if (hc && ch == prev) continue;
              prev = ch;
              if (kept++ < bc) continue;
              if (o >= ccap) return -1;
              codes[o++] = CODE[ch];
            }
          rlen[r] = o - start;
          r++;
          if (o >= ccap) return -1;
          codes[o++] = 4;                      /* read separator */
        }
    }
  boff[r] = o;
  *consumed = i;   /* i sits at the first incomplete record (or n) */
  return r;
}

/* The reference's SAM base-normalization table (io.c:1398-1477 semantics,
 * as reconstructed in io/sam.py): ASCII 0-127 -> a concrete lowercase
 * base ('a' default), bytes >= 128 -> 0 (codes invalid downstream). */
static uint8_t IUPAC2DNA[256];
static void init_iupac(void)
{ int i;
  const char *cs = "1BbCcSsYy", *gs = "2GgKk", *ts = "3Tt";
  if (IUPAC2DNA['A'] == 'a') return;
  for (i = 0; i < 128; i++) IUPAC2DNA[i] = 'a';
  for (i = 128; i < 256; i++) IUPAC2DNA[i] = 0;
  for (i = 0; cs[i]; i++) IUPAC2DNA[(int)cs[i]] = 'c';
  for (i = 0; gs[i]; i++) IUPAC2DNA[(int)gs[i]] = 'g';
  for (i = 0; ts[i]; i++) IUPAC2DNA[(int)ts[i]] = 't';
}

/* Scan SAM text lines from buf. '@' header lines are skipped; alignment
 * lines with FLAG & 0x900 or SEQ "*" are skipped; SEQ bytes translate
 * through IUPAC2DNA BEFORE hc/bc (matching io/sam.py: translate, then
 * homopolymer-compress the translated bytes). A trailing line without a
 * newline is carried unless `final` is set. Returns #reads, -1 codes
 * overflow, -2 rcap overflow, -3 malformed. */
/* fused translate: raw SAM SEQ byte -> code of its normalized base */
static uint8_t SAMCODE[256];
static int samcode_init = 0;
static void init_samcode(void)
{ int i;
  if (samcode_init) return;
  init_code();
  init_iupac();
  for (i = 0; i < 256; i++) SAMCODE[i] = CODE[IUPAC2DNA[i]];
  samcode_init = 1;
}

long fk_scan_sam(const uint8_t *buf, long n, int hc, int bc, int final,
                 uint8_t *codes, long ccap,
                 int64_t *boff, int64_t *rlen, long rcap,
                 int64_t *consumed)
{ long i = 0, o = 0, r = 0;
  init_samcode();

  while (i < n)
    { const uint8_t *ls = buf + i, *le, *q, *seq0, *seq1;
      long flag, fi;
      /* find end of line (or carry a partial one) */
      le = memchr(ls, '\n', n - i);
      if (le == NULL)
        { if (!final) break;                   /* partial line: carry */
          le = buf + n;
        }
      if (*ls == '@')                          /* header line */
        { i = (le - buf) + 1; continue; }
      /* blank line */
      { const uint8_t *p = ls; int blank = 1;
        while (p < le) { if (*p != ' ' && *p != '\t' && *p != '\r')
                           { blank = 0; break; } p++; }
        if (blank) { i = (le - buf) + 1; continue; }
      }
      /* hop tab-separated fields with memchr: field 1 = FLAG, 9 = SEQ */
      q = memchr(ls, '\t', le - ls);           /* end of QNAME */
      if (q == NULL) { *consumed = ls - buf; return -3; }
      q++;
      flag = 0;
      { const uint8_t *d = q;
        while (d < le && *d >= '0' && *d <= '9')
          flag = flag*10 + (*d++ - '0');
        if (d == q || d >= le || *d != '\t')
          { *consumed = ls - buf; return -3; }
        q = d + 1;
      }
      for (fi = 2; fi < 9; fi++)               /* skip fields 2..8 */
        { q = memchr(q, '\t', le - q);
          if (q == NULL) { *consumed = ls - buf; return -3; }
          q++;
        }
      seq0 = q;
      q = memchr(q, '\t', le - q);             /* field 10 must follow */
      if (q == NULL) { *consumed = ls - buf; return -3; }
      seq1 = q;
      i = (le - buf) + 1;
      if (flag & 0x900) continue;
      if (seq1 > seq0 && seq1[-1] == '\r') seq1--;      /* tolerate CRLF */
      if (seq1 - seq0 == 1 && *seq0 == '*') continue;
      if (r >= rcap) return -2;
      boff[r] = o;
      if (!hc && !bc)
        { long m = seq1 - seq0, j, start = o;
          if (o + m + 1 > ccap) return -1;
          for (j = 0; j < m; j++)
            codes[o + j] = SAMCODE[seq0[j]];
          o += m;
          rlen[r] = o - start;
          r++;
          codes[o++] = 4;
        }
      else
        { int  prev = -1;
          long kept = 0, start = o;
          const uint8_t *p;
          for (p = seq0; p < seq1; p++)
            { int ch = IUPAC2DNA[*p];
              if (hc && ch == prev) continue;
              prev = ch;
              if (kept++ < bc) continue;
              if (o >= ccap) return -1;
              codes[o++] = CODE[ch];
            }
          rlen[r] = o - start;
          r++;
          if (o >= ccap) return -1;
          codes[o++] = 4;
        }
    }
  boff[r] = o;
  *consumed = i < n ? i : n;
  return r;
}

/* Largest prefix of buf holding only WHOLE BAM records: hop block_size
 * fields (the producer's chunk-seam cut; no record parsing). -3 on a
 * corrupt size field. */
long fk_bam_cut(const uint8_t *buf, long n)
{ long i = 0;
  while (i + 4 <= n)
    { long bs = (long)buf[i] | ((long)buf[i+1] << 8)
              | ((long)buf[i+2] << 16) | ((long)buf[i+3] << 24);
      if (bs < 32) return -3;
      if (i + 4 + bs > n) break;
      i += 4 + bs;
    }
  return i;
}

/* ------------------------------------------------------------------ */
/* CRAM slice record walk (the per-record series interpreter of
 * io/cram_native.py:_decode_slice_records, in C — the reference decodes
 * CRAM through threaded htslib, io.c:1821-1990; block/rANS decode stays
 * in the existing native+Python layers, this covers the record loop).
 *
 * Encodings arrive as a flat table of 4-int rows {kind, a, b, c}:
 *   kind 0 EXTERNAL        a = external stream index
 *   kind 1 HUFFMAN         a = offset into htab (int64 rows), b = #lengths,
 *                          c = offset into hsym pool
 *   kind 2 BETA            a = offset, b = nbits
 *   kind 3 GAMMA           a = offset
 *   kind 4 SUBEXP          a = offset, b = k
 *   kind 5 BYTE_ARRAY_STOP a = stop byte, b = external stream index
 *   kind 6 BYTE_ARRAY_LEN  a = len-encoding row, b = val-encoding row
 *   kind 7 NULL/missing    (error if ever read)
 * htab rows per huffman length: {len, first_code, first_idx, count},
 * symbols sorted by (len, symbol) in hsym.                             */

typedef struct
{ const uint8_t *buf;
  long           len;
  long           pos;
} FkExt;

typedef struct
{ const uint8_t *buf;
  long           len;
  long           pos;
  int            bit;
} FkBits;

typedef struct
{ const int32_t *encs;     /* 4 ints per row */
  int            n_encs;
  const int64_t *htab;
  const int32_t *hsym;
  FkExt         *ext;
  int            n_ext;
  FkBits         core;
  int            err;      /* sticky error code */
} FkCram;

#define FK_ERR(D, code) ((D)->err = ((D)->err ? (D)->err : (code)))

static int fkc_bit(FkCram *D)
{ FkBits *b = &D->core;
  int v;
  if (b->pos >= b->len) { FK_ERR(D, -4); return 0; }
  v = (b->buf[b->pos] >> (7 - b->bit)) & 1;
  if (++b->bit == 8) { b->bit = 0; b->pos++; }
  return v;
}

static int64_t fkc_bits(FkCram *D, int n)
{ int64_t v = 0;
  int i;
  for (i = 0; i < n; i++)
    v = (v << 1) | fkc_bit(D);
  return v;
}

static int fkc_u8(FkCram *D, int ei)
{ FkExt *e;
  if (ei < 0 || ei >= D->n_ext) { FK_ERR(D, -4); return 0; }
  e = D->ext + ei;
  if (e->pos >= e->len) { FK_ERR(D, -4); return 0; }
  return e->buf[e->pos++];
}

static int64_t fkc_itf8(FkCram *D, int ei)
{ int64_t v;
  int b = fkc_u8(D, ei);
  if (!(b & 0x80))      v = b;
  else if (!(b & 0x40)) v = ((int64_t)(b & 0x3F) << 8) | fkc_u8(D, ei);
  else if (!(b & 0x20)) v = ((int64_t)(b & 0x1F) << 16)
                          | ((int64_t)fkc_u8(D, ei) << 8) | fkc_u8(D, ei);
  else if (!(b & 0x10)) v = ((int64_t)(b & 0x0F) << 24)
                          | ((int64_t)fkc_u8(D, ei) << 16)
                          | ((int64_t)fkc_u8(D, ei) << 8) | fkc_u8(D, ei);
  else                  v = ((int64_t)(b & 0x0F) << 28)
                          | ((int64_t)fkc_u8(D, ei) << 20)
                          | ((int64_t)fkc_u8(D, ei) << 12)
                          | ((int64_t)fkc_u8(D, ei) << 4)
                          | (fkc_u8(D, ei) & 0x0F);
  if (v >= ((int64_t)1 << 31)) v -= ((int64_t)1 << 32);  /* signed ITF8 */
  return v;
}

static int64_t fkc_huffman(FkCram *D, const int32_t *e)
{ const int64_t *t = D->htab + e[1];
  const int32_t *sym = D->hsym + e[3];
  int nl = e[2], li;
  int64_t code = 0;
  long ln = 0;
  for (li = 0; li < nl; li++)
    { long want = (long)t[4*li];
      int64_t d;
      while (ln < want) { code = (code << 1) | fkc_bit(D); ln++; }
      d = code - t[4*li + 1];
      if (d >= 0 && d < t[4*li + 3])
        return sym[t[4*li + 2] + d];
    }
  FK_ERR(D, -4);
  return 0;
}

static int64_t fkc_read_int(FkCram *D, int enc)
{ const int32_t *e;
  if (enc < 0 || enc >= D->n_encs) { FK_ERR(D, -4); return 0; }
  e = D->encs + 4*enc;
  switch (e[0])
    { case 0: return fkc_itf8(D, e[1]);
      case 1: return fkc_huffman(D, e);
      case 2: return fkc_bits(D, e[2]) - e[1];
      case 3:
        { long ln = 0; int64_t v = 1; long i;
          while (fkc_bit(D) == 0 && !D->err)
            { if (++ln > 62) { FK_ERR(D, -4); return 0; } }
          for (i = 0; i < ln; i++) v = (v << 1) | fkc_bit(D);
          return v - e[1];
        }
      case 4:
        { long i = 0; int b; int64_t nv;
          while (fkc_bit(D) == 1 && !D->err)
            { if (++i > 62) { FK_ERR(D, -4); return 0; } }
          if (i == 0) { b = e[2]; nv = fkc_bits(D, b); }
          else { b = (int)i + e[2] - 1;
                 nv = ((int64_t)1 << b) | fkc_bits(D, b); }
          return nv - e[1];
        }
      default: FK_ERR(D, -4); return 0;
    }
}

static int fkc_read_byte(FkCram *D, int enc)
{ const int32_t *e;
  if (enc < 0 || enc >= D->n_encs) { FK_ERR(D, -4); return 0; }
  e = D->encs + 4*enc;
  if (e[0] == 0) return fkc_u8(D, e[1]);
  if (e[0] == 1 || e[0] == 2) return (int)fkc_read_int(D, enc);
  FK_ERR(D, -4);
  return 0;
}

/* read a byte array; out == NULL discards (stream positions advance the
 * same). Returns the length (clamped to ocap when out != NULL). */
static long fkc_read_bytes(FkCram *D, int enc, uint8_t *out, long ocap)
{ const int32_t *e;
  if (enc < 0 || enc >= D->n_encs) { FK_ERR(D, -4); return 0; }
  e = D->encs + 4*enc;
  if (e[0] == 5)                             /* byte_array_stop */
    { int ei = e[2];
      FkExt *x;
      const uint8_t *hit;
      long m;
      if (ei < 0 || ei >= D->n_ext) { FK_ERR(D, -4); return 0; }
      x = D->ext + ei;
      hit = memchr(x->buf + x->pos, e[1], x->len - x->pos);
      if (hit == NULL) { FK_ERR(D, -4); return 0; }
      m = hit - (x->buf + x->pos);
      if (out != NULL)
        { if (m > ocap) { FK_ERR(D, -6); return 0; }
          memcpy(out, x->buf + x->pos, m);
        }
      x->pos += m + 1;
      return m;
    }
  if (e[0] == 6)                             /* byte_array_len */
    { long m = (long)fkc_read_int(D, e[1]);
      const int32_t *v;
      if (D->err || m < 0) { FK_ERR(D, -4); return 0; }
      if (e[2] < 0 || e[2] >= D->n_encs) { FK_ERR(D, -4); return 0; }
      v = D->encs + 4*e[2];
      if (v[0] == 0)                         /* external: bulk slice */
        { int ei = v[1];
          FkExt *x;
          if (ei < 0 || ei >= D->n_ext) { FK_ERR(D, -4); return 0; }
          x = D->ext + ei;
          if (x->pos + m > x->len) { FK_ERR(D, -4); return 0; }
          if (out != NULL)
            { if (m > ocap) { FK_ERR(D, -6); return 0; }
              memcpy(out, x->buf + x->pos, m);
            }
          x->pos += m;
          return m;
        }
      { long j;
        if (out != NULL && m > ocap) { FK_ERR(D, -6); return 0; }
        for (j = 0; j < m; j++)
          { int b = fkc_read_byte(D, e[2]);
            if (out != NULL) out[j] = (uint8_t)b;
          }
        return m;
      }
    }
  FK_ERR(D, -4);
  return 0;
}

/* ref base byte -> row of the substitution matrix (A C G T N) */
static uint8_t RIDX[256];
static void init_ridx(void)
{ int i;
  for (i = 0; i < 256; i++) RIDX[i] = 4;
  RIDX['A'] = 0; RIDX['C'] = 1; RIDX['G'] = 2; RIDX['T'] = 3;
  RIDX['N'] = 4;
}

/* all lazy table inits run once at library load, BEFORE any worker
 * thread can enter a scanner: the per-call lazy checks are unsynchronized
 * and a reordered init-flag store could expose a half-filled table to a
 * concurrent caller (the ingest pool calls these from many threads). */
__attribute__((constructor)) static void fk_init_all(void)
{ init_code();
  init_iupac();
  init_samcode();
  init_nib2();
  init_ridx();
  init_gctab();
}

/* series slot order (io/cram_native.py keeps the Python list in sync) */
enum { S_BF, S_CF, S_RI, S_RL, S_AP, S_RG, S_RN, S_MF, S_NS, S_NP, S_TS,
       S_NF, S_TL, S_FN, S_FC, S_FP, S_BS, S_SC, S_IN, S_BA, S_BB, S_QS,
       S_QQ, S_DL, S_RS, S_PD, S_HC, S_MQ, S_COUNT };

static int64_t fkc_series_int(FkCram *D, const int32_t *series, int s)
{ if (series[s] < 0) { FK_ERR(D, -4); return 0; }
  return fkc_read_int(D, series[s]);
}

long fk_cram_slice(
    const int32_t *encs, int n_encs,
    const int64_t *htab, const int32_t *hsym,
    const int32_t *series,
    const int32_t *tag_off, int n_lines, const int32_t *tag_enc,
    void **ext_ptrs, const int64_t *ext_lens, int n_ext,
    const uint8_t *core, long core_len,
    const uint8_t *ref, int64_t ref_start, long ref_len,
    void **ref_ptrs, const int64_t *ref_lens, int n_refs,
    const uint8_t *subs,             /* 5x4: subs[ri*4 + code] */
    int rn_preserved, int ap_delta, int multi_ref, int64_t slice_start,
    long n_records, int hc, int bc,
    uint8_t *codes, long ccap, int64_t *boff, int64_t *rlen_out, long rcap)
{ FkCram Dv, *D = &Dv;
  long rec, o = 0, r = 0;
  long scap = 1 << 16;
  uint8_t *seq = malloc(scap);
  int64_t last_pos = slice_start;

  if (seq == NULL) return -7;

  D->encs = encs; D->n_encs = n_encs;
  D->htab = htab; D->hsym = hsym;
  D->n_ext = n_ext;
  D->ext = malloc(sizeof(FkExt) * (n_ext > 0 ? n_ext : 1));
  if (D->ext == NULL) { free(seq); return -7; }
  { int i;
    for (i = 0; i < n_ext; i++)
      { D->ext[i].buf = (const uint8_t *)ext_ptrs[i];
        D->ext[i].len = ext_lens[i];
        D->ext[i].pos = 0;
      }
  }
  D->core.buf = core; D->core.len = core_len;
  D->core.pos = 0; D->core.bit = 0;
  D->err = 0;

  for (rec = 0; rec < n_records; rec++)
    { int64_t bf, cf, rl, pos, tl;
      long have, j;
      int64_t rpos;
      int no_seq;
      const uint8_t *rref;
      long rref_len;

      bf = fkc_series_int(D, series, S_BF);
      cf = fkc_series_int(D, series, S_CF);
      rref = NULL; rref_len = 0;
      if (multi_ref)
        { int64_t ri = fkc_series_int(D, series, S_RI);
          /* mapped records read their contig from the per-ref table
             (N-padded past either end, like Reference.get) */
          if (ri >= 0 && ri < n_refs)
            { rref = (const uint8_t *)ref_ptrs[ri];
              rref_len = ref_lens[ri];
            }
        }
      rl = fkc_series_int(D, series, S_RL);
      if (ap_delta)
        { last_pos += fkc_series_int(D, series, S_AP); pos = last_pos; }
      else
        pos = fkc_series_int(D, series, S_AP);
      fkc_series_int(D, series, S_RG);
      if (rn_preserved)
        fkc_read_bytes(D, series[S_RN], NULL, 0);
      if (cf & 0x2)                              /* detached */
        { fkc_series_int(D, series, S_MF);
          if (!rn_preserved)
            fkc_read_bytes(D, series[S_RN], NULL, 0);
          fkc_series_int(D, series, S_NS);
          fkc_series_int(D, series, S_NP);
          fkc_series_int(D, series, S_TS);
        }
      else if (cf & 0x4)                         /* mate downstream */
        fkc_series_int(D, series, S_NF);
      tl = fkc_series_int(D, series, S_TL);
      if (tl >= 0 && tl < n_lines)
        { int32_t t;
          for (t = tag_off[tl]; t < tag_off[tl + 1]; t++)
            fkc_read_bytes(D, tag_enc[t], NULL, 0);
        }
      if (D->err) goto fail;
      if (rl < 0 || rl > (long)1 << 31) { FK_ERR(D, -4); goto fail; }
      if (rl + 64 > scap)
        { long ns = scap;
          uint8_t *nb;
          while (rl + 64 > ns) ns *= 2;
          nb = realloc(seq, ns);
          if (nb == NULL) { FK_ERR(D, -7); goto fail; }
          seq = nb; scap = ns;
        }

      no_seq = (cf & 0x8) != 0;
      if (bf & 0x4)                              /* unmapped */
        { if (no_seq)
            memset(seq, 'N', rl);
          else
            { /* BA byte run: bulk when external */
              int enc = series[S_BA];
              const int32_t *e;
              if (enc < 0) { FK_ERR(D, -4); goto fail; }
              e = D->encs + 4*enc;
              if (e[0] == 0)
                { FkExt *x;
                  if (e[1] < 0 || e[1] >= n_ext) { FK_ERR(D, -4); goto fail; }
                  x = D->ext + e[1];
                  if (x->pos + rl > x->len) { FK_ERR(D, -4); goto fail; }
                  memcpy(seq, x->buf + x->pos, rl);
                  x->pos += rl;
                }
              else
                for (j = 0; j < rl; j++)
                  seq[j] = (uint8_t)fkc_read_byte(D, enc);
            }
          if (cf & 0x1)                          /* QS stored: skip run */
            { int enc = series[S_QS];
              const int32_t *e;
              if (enc < 0) { FK_ERR(D, -4); goto fail; }
              e = D->encs + 4*enc;
              if (e[0] == 0)
                { FkExt *x;
                  if (e[1] < 0 || e[1] >= n_ext) { FK_ERR(D, -4); goto fail; }
                  x = D->ext + e[1];
                  if (x->pos + rl > x->len) { FK_ERR(D, -4); goto fail; }
                  x->pos += rl;
                }
              else
                for (j = 0; j < rl; j++) fkc_read_byte(D, enc);
            }
        }
      else
        { /* mapped: reconstruct against the reference window */
          int64_t nfeat = fkc_series_int(D, series, S_FN);
          int64_t fpos = 0;
          long f;
          have = 0;
          rpos = pos;
          if (D->err) goto fail;
          for (f = 0; f < nfeat; f++)
            { int code = fkc_read_byte(D, series[S_FC]);
              int64_t gap;
              fpos += fkc_series_int(D, series, S_FP);
              gap = fpos - 1 - have;
              if (gap > 0)
                { if (have + gap > rl) { FK_ERR(D, -4); goto fail; }
                  if (no_seq)
                    memset(seq + have, 'N', gap);
                  else if (multi_ref)
                    { if (rref == NULL) { FK_ERR(D, -5); goto fail; }
                      for (j = 0; j < gap; j++)
                        { int64_t rp = rpos - 1 + j;
                          seq[have + j] = (rp >= 0 && rp < rref_len)
                                          ? rref[rp] : 'N';
                        }
                    }
                  else
                    { if (ref == NULL || rpos - ref_start < 0
                          || rpos - ref_start + gap > ref_len)
                        { FK_ERR(D, -5); goto fail; }
                      memcpy(seq + have, ref + (rpos - ref_start), gap);
                    }
                  have += gap; rpos += gap;
                }
              switch (code)
                { case 'X':
                    { int bs = fkc_read_byte(D, series[S_BS]);
                      if (have >= rl) { FK_ERR(D, -4); goto fail; }
                      if (no_seq)
                        seq[have] = 'N';
                      else
                        { int rb, rbyte;
                          if (multi_ref)
                            { int64_t rp = rpos - 1;
                              if (rref == NULL) { FK_ERR(D, -5); goto fail; }
                              rbyte = (rp >= 0 && rp < rref_len)
                                      ? rref[rp] : 'N';
                            }
                          else
                            { if (ref == NULL || rpos - ref_start < 0
                                  || rpos - ref_start >= ref_len)
                                { FK_ERR(D, -5); goto fail; }
                              rbyte = ref[rpos - ref_start];
                            }
                          rb = RIDX[rbyte];
                          if (bs < 0 || bs > 3) { FK_ERR(D, -4); goto fail; }
                          seq[have] = subs[rb*4 + bs];
                        }
                      have++; rpos++;
                      break;
                    }
                  case 'S':
                    have += fkc_read_bytes(D, series[S_SC], seq + have,
                                           rl - have);
                    break;
                  case 'I':
                    have += fkc_read_bytes(D, series[S_IN], seq + have,
                                           rl - have);
                    break;
                  case 'i':
                    if (have >= rl) { FK_ERR(D, -4); goto fail; }
                    seq[have++] = (uint8_t)fkc_read_byte(D, series[S_BA]);
                    break;
                  case 'b':
                    { long m = fkc_read_bytes(D, series[S_BB], seq + have,
                                              rl - have);
                      have += m; rpos += m;
                      break;
                    }
                  case 'B':
                    if (have >= rl) { FK_ERR(D, -4); goto fail; }
                    seq[have++] = (uint8_t)fkc_read_byte(D, series[S_BA]);
                    rpos++;
                    fkc_read_byte(D, series[S_QS]);
                    break;
                  case 'q':
                    fkc_read_bytes(D, series[S_QQ], NULL, 0);
                    break;
                  case 'Q':
                    fkc_read_byte(D, series[S_QS]);
                    break;
                  case 'D':
                    rpos += fkc_series_int(D, series, S_DL);
                    break;
                  case 'N':
                    rpos += fkc_series_int(D, series, S_RS);
                    break;
                  case 'P':
                    fkc_series_int(D, series, S_PD);
                    break;
                  case 'H':
                    fkc_series_int(D, series, S_HC);
                    break;
                  default:
                    FK_ERR(D, -4); goto fail;
                }
              if (D->err) goto fail;
            }
          if (have < rl)
            { long gap = rl - have;
              if (no_seq)
                memset(seq + have, 'N', gap);
              else if (multi_ref)
                { if (rref == NULL) { FK_ERR(D, -5); goto fail; }
                  for (j = 0; j < gap; j++)
                    { int64_t rp = rpos - 1 + j;
                      seq[have + j] = (rp >= 0 && rp < rref_len)
                                      ? rref[rp] : 'N';
                    }
                }
              else
                { if (ref == NULL || rpos - ref_start < 0
                      || rpos - ref_start + gap > ref_len)
                    { FK_ERR(D, -5); goto fail; }
                  memcpy(seq + have, ref + (rpos - ref_start), gap);
                }
              have += gap; rpos += gap;
            }
          fkc_series_int(D, series, S_MQ);
          if (cf & 0x1)
            { int enc = series[S_QS];
              const int32_t *e;
              if (enc < 0) { FK_ERR(D, -4); goto fail; }
              e = D->encs + 4*enc;
              if (e[0] == 0)
                { FkExt *x;
                  if (e[1] < 0 || e[1] >= n_ext) { FK_ERR(D, -4); goto fail; }
                  x = D->ext + e[1];
                  if (x->pos + rl > x->len) { FK_ERR(D, -4); goto fail; }
                  x->pos += rl;
                }
              else
                for (j = 0; j < rl; j++) fkc_read_byte(D, enc);
            }
        }
      if (D->err) goto fail;

      /* emit (skip secondary/supplementary and empty SEQs, matching
       * iter_cram_reads_native) */
      if ((bf & 0x900) || rl == 0)
        continue;
      if (r >= rcap) { FK_ERR(D, -2); goto fail; }
      boff[r] = o;
      { int  prev = -1;
        long kept = 0, start = o;
        for (j = 0; j < rl; j++)
          { int ch = seq[j];
            if (hc && ch == prev) continue;
            prev = ch;
            if (kept++ < bc) continue;
            if (o >= ccap) { FK_ERR(D, -1); goto fail; }
            codes[o++] = CODE[ch];
          }
        rlen_out[r] = o - start;
        r++;
        if (o >= ccap) { FK_ERR(D, -1); goto fail; }
        codes[o++] = 4;
      }
    }
  boff[r] = o;
  free(seq);
  free(D->ext);
  return r;

fail:
  { int err = D->err ? D->err : -4;
    free(seq);
    free(D->ext);
    return err;
  }
}

/* ------------------------------------------------------------------ */
/* Symmex bucket engine: LSD-radix sort the RC rows of one first-byte
 * bucket and linear-merge them with the (already sorted) forward stream
 * into writer-format rows (reference Symmex.c sorts each 2-bit-prefix
 * block then concatenates; here the merge IS the concatenation since the
 * two streams are key-disjoint).
 *
 * fwd:  nf forward keys (kb bytes each) + uint16 counts fc
 * rc:   nr RC rows of (kb key bytes + 2 count bytes), first byte uniform
 * tmp:  scratch for nr rows
 * out:  nf + nr merged rows
 * Returns nf + nr. */
long fk_symmex_bucket(int kb,
                      const uint8_t *fwd, const uint16_t *fc, long nf,
                      uint8_t *rc, long nr, uint8_t *tmp,
                      uint8_t *out)
{ int rb = kb + 2;
  long cnt[256], pos[256];
  int byte;
  long i;
  uint8_t *src = rc, *dst = tmp;

  /* LSD counting sort over key bytes kb-1 .. 1 (byte 0 is the bucket) */
  for (byte = kb - 1; byte >= 1; byte--)
    { long c;
      memset(cnt, 0, sizeof(cnt));
      for (i = 0; i < nr; i++)
        cnt[src[i*rb + byte]]++;
      c = 0;
      for (i = 0; i < 256; i++)
        { pos[i] = c; c += cnt[i]; }
      for (i = 0; i < nr; i++)
        memcpy(dst + (pos[src[i*rb + byte]]++)*rb, src + i*rb, rb);
      { uint8_t *t = src; src = dst; dst = t; }
    }

  /* linear merge (streams are key-disjoint; '<' tie-break is moot) */
  { long fi = 0, ri = 0;
    uint8_t *o = out;
    while (fi < nf && ri < nr)
      { if (memcmp(fwd + fi*kb, src + ri*rb, kb) < 0)
          { memcpy(o, fwd + fi*kb, kb);
            o[kb]   = (uint8_t)(fc[fi] & 0xFF);
            o[kb+1] = (uint8_t)(fc[fi] >> 8);
            fi++;
          }
        else
          { memcpy(o, src + ri*rb, rb);
            ri++;
          }
        o += rb;
      }
    for (; fi < nf; fi++, o += rb)
      { memcpy(o, fwd + fi*kb, kb);
        o[kb]   = (uint8_t)(fc[fi] & 0xFF);
        o[kb+1] = (uint8_t)(fc[fi] >> 8);
      }
    if (ri < nr)
      memcpy(o, src + ri*rb, (nr - ri)*rb);
  }
  return nf + nr;
}
