/* The part of libzstd's stable API that native/silo_ndjson.cpp calls,
 * declared as zstd.h (1.4 and later) declares it. The port builds the NDJSON
 * scanner against this file only where libzstd's runtime library is
 * installed without its header (lapis_silo_torch/native.py). */
#ifndef ZSTD_H_235446
#define ZSTD_H_235446

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct ZSTD_CCtx_s ZSTD_CCtx;

size_t ZSTD_compressBound(size_t srcSize);
unsigned ZSTD_isError(size_t code);
ZSTD_CCtx* ZSTD_createCCtx(void);
size_t ZSTD_freeCCtx(ZSTD_CCtx* cctx);
size_t ZSTD_compress_usingDict(ZSTD_CCtx* ctx, void* dst, size_t dstCapacity,
                               const void* src, size_t srcSize,
                               const void* dict, size_t dictSize,
                               int compressionLevel);

#ifdef __cplusplus
}
#endif

#endif /* ZSTD_H_235446 */
