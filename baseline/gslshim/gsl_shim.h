/* Minimal GSL API shim — just enough surface to compile and run the
 * reference CSS kernel (reference statistics/css/css.c:15-18,421-430,
 * 533-555) in an image without libgsl.  Implements:
 *   - row-major matrix/vector views (gsl_matrix_view_array,
 *     gsl_matrix_column)
 *   - gsl_blas_dgemm (NoTrans/NoTrans path is all css.c uses)
 *   - gsl_eigen_symmv via cyclic Jacobi + gsl_eigen_symmv_sort
 *
 * This is BASELINE INFRASTRUCTURE for honest benchmarking of the
 * reference C code on the host; it is not
 * part of the divergence_tpu framework proper.  The shim is written
 * from the public GSL API documentation, not from GSL source.
 */
#ifndef GSL_SHIM_H
#define GSL_SHIM_H

#include <stddef.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef struct {
    size_t size1; /* rows */
    size_t size2; /* cols */
    size_t tda;   /* row stride (elements) */
    double *data;
} gsl_matrix;

typedef struct {
    gsl_matrix matrix;
} gsl_matrix_view;

typedef struct {
    size_t size;
    size_t stride;
    double *data;
} gsl_vector;

typedef struct {
    gsl_vector vector;
} gsl_vector_view;

typedef struct {
    size_t n;
} gsl_eigen_symmv_workspace;

typedef enum {
    CblasNoTrans = 111,
    CblasTrans = 112,
    CblasConjTrans = 113
} CBLAS_TRANSPOSE_t;

typedef enum {
    GSL_EIGEN_SORT_VAL_ASC,
    GSL_EIGEN_SORT_VAL_DESC,
    GSL_EIGEN_SORT_ABS_ASC,
    GSL_EIGEN_SORT_ABS_DESC
} gsl_eigen_sort_t;

gsl_matrix_view gsl_matrix_view_array(double *base, size_t n1, size_t n2);
gsl_matrix *gsl_matrix_alloc(size_t n1, size_t n2);
void gsl_matrix_free(gsl_matrix *m);
gsl_vector_view gsl_matrix_column(gsl_matrix *m, size_t j);

gsl_vector *gsl_vector_alloc(size_t n);
void gsl_vector_free(gsl_vector *v);
double gsl_vector_get(const gsl_vector *v, size_t i);

int gsl_blas_dgemm(CBLAS_TRANSPOSE_t ta, CBLAS_TRANSPOSE_t tb,
                   double alpha, const gsl_matrix *A, const gsl_matrix *B,
                   double beta, gsl_matrix *C);

gsl_eigen_symmv_workspace *gsl_eigen_symmv_alloc(size_t n);
void gsl_eigen_symmv_free(gsl_eigen_symmv_workspace *w);
int gsl_eigen_symmv(gsl_matrix *A, gsl_vector *eval, gsl_matrix *evec,
                    gsl_eigen_symmv_workspace *w);
int gsl_eigen_symmv_sort(gsl_vector *eval, gsl_matrix *evec,
                         gsl_eigen_sort_t sort_type);

#ifdef __cplusplus
}
#endif

#endif /* GSL_SHIM_H */
